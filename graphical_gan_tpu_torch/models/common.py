"""Shared model utilities (``graphical_gan_tpu/models/common.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.norm import batchnorm_act


def normalize_input(cfg, raw: torch.Tensor, compute_dtype: torch.dtype,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Per-dataset raw -> network-input mapping (``config.DataSpec``):
    mnist [0,1] passthrough; cifar/svhn int -> [-1,1] via /255; celebA
    int -> [-1,1] via /256 plus U(0, 1/128) dequantization noise (drawn from
    ``generator``); video float [0,1] -> [-1,1]; chairs int /256. The result
    is cast to the compute dtype, as ``models/common.py:34``."""
    norm = cfg.data.normalization
    x = raw.float()
    if norm == "unit":
        pass
    elif norm == "int_pm1":
        x = 2.0 * (x / 255.0 - 0.5)
    elif norm == "dequant":
        x = 2.0 * (x / 256.0 - 0.5)
        x = x + torch.rand(x.shape, generator=generator,
                           device=x.device) / 128.0
    elif norm == "unit_pm1":
        x = 2.0 * (x - 0.5)
    elif norm == "int256_pm1":
        x = 2.0 * (x / 256.0 - 0.5)
    else:
        raise ValueError(norm)
    return x.to(compute_dtype)


def bn_act(flag: bool, params: Dict[str, torch.Tensor], name: str,
           x: torch.Tensor, act: str, axes=None) -> torch.Tensor:
    """act(batchnorm(x)) when BN is on, else the plain activation."""
    if flag:
        return batchnorm_act(params, name, x, act, axes=axes)
    return activation(act)(x)
