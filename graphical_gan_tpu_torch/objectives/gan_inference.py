"""Adversarial-inference losses over (data, code) pairs
(``graphical_gan_tpu/objectives/gan_inference.py``). Each returns
``(gen_cost, disc_cost)``. This slice ports wali-gp; the other objectives
come with the rest of family 1.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wali_gp(disc_fake: torch.Tensor, disc_real: torch.Tensor,
            gradient_penalty: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wasserstein ALI + gradient penalty (``gan_inference.py:28-45``).
    The means are taken in the scores' dtype, as ``jnp.mean`` does."""
    gen_cost = -disc_fake.mean() + disc_real.mean()
    disc_cost = disc_fake.mean() - disc_real.mean() + gradient_penalty
    return gen_cost, disc_cost
