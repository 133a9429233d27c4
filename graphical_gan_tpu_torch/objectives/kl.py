"""Closed-form diagonal-Gaussian divergences
(``graphical_gan_tpu/objectives/kl.py``)."""

from __future__ import annotations

import math

import torch


def kl_q_p_diagonal_gaussian(q_mean, q_std, p_mean, p_std) -> torch.Tensor:
    """KL(q || p) for diagonal Gaussians, summed over dims, batch-averaged
    (``kl.py:5-10``)."""
    q_var = q_std.square()
    p_var = p_std.square()
    res = 0.5 * (torch.log(p_var / q_var)
                 + ((p_mean - q_mean).square() + q_var) / p_var - 1.0)
    return res.sum(dim=1).mean(dim=0)


def neg_log_likelihood_diagonal_gaussian(x, mu, std) -> torch.Tensor:
    """``kl.py:12-14``."""
    res = 0.5 * (((x - mu) / std).square() + math.log(2 * math.pi)
                 + 2.0 * torch.log(std))
    return res.sum(dim=1).mean(dim=0)


def vae(real_x, p_x_mean, p_x_std, q_z_mean, q_z_std, p_z_mean, p_z_std
        ) -> torch.Tensor:
    """The negative VAE ELBO, a generator-only objective (``kl.py:16-24``)."""
    return kl_q_p_diagonal_gaussian(q_z_mean, q_z_std, p_z_mean, p_z_std) \
        + neg_log_likelihood_diagonal_gaussian(real_x, p_x_mean, p_x_std)
