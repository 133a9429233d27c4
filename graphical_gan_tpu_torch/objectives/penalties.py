"""Gradient penalties (``graphical_gan_tpu/objectives/penalties.py``).

The penalty differentiates the discriminator's input-gradient again, so
every op on D's path has a differentiable backward (``torch.autograd.grad``
with ``create_graph=True``).
"""

from __future__ import annotations

from typing import Callable

import torch


def gradient_penalty_xz(d_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                        real_x: torch.Tensor, fake_x: torch.Tensor,
                        q_z: torch.Tensor, p_z: torch.Tensor,
                        alpha: torch.Tensor,
                        lamb: float = 10.0) -> torch.Tensor:
    """wali-gp penalty (``penalties.py:74-93``): one per-example ``alpha``
    ([B, 1], f32) interpolates both x and z; the slope comes from the
    x-gradient only, in that gradient's dtype. As in JAX, the f32 alpha
    promotes bf16 inputs, so D runs in f32 on the interpolates."""
    x_hat = real_x + alpha * (fake_x - real_x)
    z_hat = q_z + alpha * (p_z - q_z)
    if not x_hat.requires_grad:  # inputs made under no_grad
        x_hat.requires_grad_(True)
    (grads_x,) = torch.autograd.grad(d_fn(x_hat, z_hat).sum(), x_hat,
                                     create_graph=True)
    slopes = torch.sqrt(grads_x.square().sum(dim=1))
    return lamb * (slopes - 1.0).square().mean()
