"""Gradient penalties and reconstruction distances
(``graphical_gan_tpu/objectives/penalties.py``).

A penalty differentiates the discriminator's input-gradient again, so every
op on D's path has a differentiable backward (``torch.autograd.grad`` with
``create_graph=True``). That inner pass runs inside
``fused_conv.input_grads_only``: K1's backward there computes D's input
gradients only, as XLA's dead-code elimination leaves the JAX step. Each takes its interpolation weights ``alpha``
([B, 1], f32) from the caller, who draws them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from graphical_gan_tpu_torch.ops.kernels.fused_conv import input_grads_only


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).square().mean()


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def distance(x: torch.Tensor, y: torch.Tensor, d_type: str) -> torch.Tensor:
    """``tflib/utils/distance.py:3-17``."""
    if d_type == "l1":
        return l1(x, y)
    if d_type == "l2":
        return l2(x, y)
    raise ValueError(f"unknown distance {d_type!r}")


def _input_grads(d_fn, hats: Sequence[torch.Tensor], wrt: Sequence[int]):
    for i in wrt:
        if not hats[i].requires_grad:  # inputs made under no_grad
            hats[i].requires_grad_(True)
    out = d_fn(*hats).sum()
    with input_grads_only():
        return torch.autograd.grad(out, [hats[i] for i in wrt],
                                   create_graph=True)


def _penalty(grads: Sequence[torch.Tensor], lamb: float) -> torch.Tensor:
    b = grads[0].shape[0]
    flat = torch.cat([g.reshape(b, -1) for g in grads], dim=1)
    slopes = torch.sqrt(flat.square().sum(dim=1))
    return lamb * (slopes - 1.0).square().mean()


def gradient_penalty_xz(d_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                        real_x: torch.Tensor, fake_x: torch.Tensor,
                        q_z: torch.Tensor, p_z: torch.Tensor,
                        alpha: torch.Tensor,
                        lamb: float = 10.0) -> torch.Tensor:
    """wali-gp penalty (``penalties.py:74-93``): one per-example ``alpha``
    interpolates both x and z; the slope comes from the x-gradient only, in
    that gradient's dtype. As in JAX, the f32 alpha promotes bf16 inputs,
    so D runs in f32 on the interpolates."""
    x_hat = real_x + alpha * (fake_x - real_x)
    z_hat = q_z + alpha * (p_z - q_z)
    return _penalty(_input_grads(d_fn, [x_hat, z_hat], [0]), lamb)


def wali_gp_fused(d_fn: Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor],
                  real_x: torch.Tensor, fake_x: torch.Tensor,
                  q_z: torch.Tensor, p_z: torch.Tensor,
                  alpha: torch.Tensor, lamb: float = 10.0):
    """``gradient_penalty_xz`` for a row-wise discriminator
    (``penalties.py:34-69``): one D apply over [real; fake; interpolates]
    (3B rows) and one input-gradient pass with the cotangent 1 on the
    interpolates' rows, in place of three D forwards and a gradient pass.
    Exact only where no op couples the rows (no batch-statistics BN), which
    the caller checks. The interpolates are cast back to the inputs' dtype,
    as JAX casts them, and the slopes are taken in f32. Returns
    ``(disc_real, disc_fake, gp)``."""
    b = real_x.shape[0]
    x_hat = real_x + alpha * (fake_x - real_x)
    z_hat = q_z + alpha * (p_z - q_z)
    xs = torch.cat([real_x, fake_x, x_hat.to(real_x.dtype)])
    zs = torch.cat([q_z, p_z, z_hat.to(q_z.dtype)])
    if not xs.requires_grad:  # inputs made under no_grad
        xs.requires_grad_(True)
    out = d_fn(xs, zs)
    cot = torch.zeros_like(out)
    cot[2 * b:] = 1.0
    with input_grads_only():
        (grads_xs,) = torch.autograd.grad(out, xs, grad_outputs=cot,
                                          create_graph=True)
    slopes = torch.sqrt(grads_xs[2 * b:].float().square().sum(dim=1))
    gp = lamb * (slopes - 1.0).square().mean()
    return out[:b], out[b:2 * b], gp


def gradient_penalty_z(d_fn: Callable[[torch.Tensor], torch.Tensor],
                       q_z: torch.Tensor, p_z: torch.Tensor,
                       alpha: torch.Tensor, lamb: float = 10.0
                       ) -> torch.Tensor:
    """vegan-wgan-gp penalty in code space (``penalties.py:95-110``):
    interpolates from p_z toward q_z."""
    z_hat = p_z + alpha * (q_z - p_z)
    return _penalty(_input_grads(d_fn, [z_hat], [0]), lamb)


def gradient_penalty(d_fn: Callable[..., torch.Tensor],
                     reals: Sequence[torch.Tensor],
                     fakes: Sequence[torch.Tensor], alpha: torch.Tensor,
                     lamb: float = 10.0,
                     slope_argnums: Sequence[int] = (0,)) -> torch.Tensor:
    """General WGAN-GP over any tuple of interpolated inputs with one
    shared ``alpha`` ([B] plus ones to the first input's rank), on the L2
    slope of the gradients with respect to the ``slope_argnums`` inputs,
    concatenated (``penalties.py:113-133``)."""
    b = reals[0].shape[0]
    hats = [r + alpha.reshape((b,) + (1,) * (r.ndim - 1)) * (f - r)
            for r, f in zip(reals, fakes)]
    return _penalty(_input_grads(d_fn, hats, tuple(slope_argnums)), lamb)
