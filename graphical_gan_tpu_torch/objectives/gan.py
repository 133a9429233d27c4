"""Plain (non-inference) GAN losses (``graphical_gan_tpu/objectives/
gan.py``, ``tflib/objs/gan.py``). Each returns ``(gen_cost, disc_cost)``;
``objectives/common.py: optimizer_for`` holds each one's optimizer."""

from __future__ import annotations

from typing import Tuple

import torch

from graphical_gan_tpu_torch.objectives.common import sigmoid_ce

Pair = Tuple[torch.Tensor, torch.Tensor]


def wgan(disc_fake: torch.Tensor, disc_real: torch.Tensor) -> Pair:
    """``gan.py:4-26``: RMSProp 5e-5 and a 0.01 weight clip."""
    gen_cost = -disc_fake.mean()
    disc_cost = disc_fake.mean() - disc_real.mean()
    return gen_cost, disc_cost


def wgan_gp(disc_fake: torch.Tensor, disc_real: torch.Tensor,
            gradient_penalty: torch.Tensor) -> Pair:
    """``gan.py:28-48``: Adam 1e-4 (0.5, 0.9)."""
    gen_cost = -disc_fake.mean()
    disc_cost = disc_fake.mean() - disc_real.mean() + gradient_penalty
    return gen_cost, disc_cost


def gan(disc_fake: torch.Tensor, disc_real: torch.Tensor) -> Pair:
    """The non-saturating GAN (``gan.py:50-78``), the disc cost halved."""
    gen_cost = sigmoid_ce(disc_fake, 1.0)
    disc_cost = (sigmoid_ce(disc_fake, 0.0)
                 + sigmoid_ce(disc_real, 1.0)) / 2.0
    return gen_cost, disc_cost
