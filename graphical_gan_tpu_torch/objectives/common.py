"""Shared loss primitives and optimizer presets
(``graphical_gan_tpu/objectives/common.py``).

The reference hard-coded each objective's optimizer inside its loss
function; the JAX package keeps those choices as declarative ``OptSpec``
presets keyed by objective name, and so does the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def sigmoid_ce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Mean sigmoid cross-entropy against a constant label, in f32:
    ``max(l, 0) - l*z + log(1 + exp(-|l|))``, as
    ``tf.nn.sigmoid_cross_entropy_with_logits`` averaged over the batch."""
    lg = logits.float()
    per = torch.clamp_min(lg, 0.0) - lg * label \
        + torch.log1p(torch.exp(-lg.abs()))
    return per.mean()


@dataclass(frozen=True)
class OptSpec:
    """Which optimizer an objective trains each player with."""
    kind: str = "adam"          # 'adam' | 'rmsprop'
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    eps: float = 1e-8           # adam; rmsprop uses 1e-10 (TF default)
    weight_clip: Optional[float] = None   # post-update clip (wali/wgan)


def optimizer_for(objective: str, lr: Optional[float] = None,
                  beta1: Optional[float] = None,
                  beta2: Optional[float] = None) -> OptSpec:
    """Optimizer preset per objective (``tflib/objs/gan_inference.py``):

    - wali / wgan: RMSProp lr=5e-5 + weight clip +-0.01;
    - wali_gp / wgan_gp: Adam 1e-4 (0.5, 0.9);
    - everything else: Adam 2e-4 (0.5, 0.999-or-passed).
    """
    if objective in ("wali", "wgan"):
        return OptSpec(kind="rmsprop", lr=lr if lr is not None else 5e-5,
                       weight_clip=0.01)
    if objective in ("wali_gp", "wgan_gp", "wali-gp", "wgan-gp"):
        return OptSpec(kind="adam", lr=lr if lr is not None else 1e-4,
                       beta1=0.5, beta2=0.9)
    return OptSpec(kind="adam",
                   lr=lr if lr is not None else 2e-4,
                   beta1=beta1 if beta1 is not None else 0.5,
                   beta2=beta2 if beta2 is not None else 0.999)
