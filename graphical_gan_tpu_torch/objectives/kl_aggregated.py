"""Monte-Carlo divergences between the aggregated posterior and the prior
(``graphical_gan_tpu/objectives/kl_aggregated.py``): the batch of
per-example posteriors is an equal-weight Gaussian mixture, and KL, inverse
KL and JSD against N(0, I) are estimated from samples with the log-sum-exp
trick. The samples' random numbers come from the caller: ``idx`` [S]
mixture components and ``eps`` [S, z] standard normals for a draw from the
mixture, ``z_prior`` [S, z] for a draw from the prior.
"""

from __future__ import annotations

import math

import torch


def mixture_gaussian(idx: torch.Tensor, eps: torch.Tensor, mu: torch.Tensor,
                     std: torch.Tensor) -> torch.Tensor:
    """Samples of the uniform-weight mixture (``kl_aggregated.py:6-16``):
    component ``idx`` of (mu, std) [n_coms, z], moved by ``eps``."""
    return mu.float()[idx] + std.float()[idx] * eps


def log_likelihood_diagonal_gaussian(x, mu, std) -> torch.Tensor:
    """``kl_aggregated.py:18-20``: summed over the last axis."""
    res = -0.5 * (((x - mu) / std).square() + math.log(2 * math.pi)
                  + 2.0 * torch.log(std))
    return res.sum(dim=-1)


def _log_mean_exp(res_mat: torch.Tensor) -> torch.Tensor:
    res_max = res_mat.max(dim=1).values
    return torch.log(torch.exp(res_mat - res_max[:, None]).mean(dim=1)) \
        + res_max


def log_likelihood_mixture_gaussian(x, mu, std) -> torch.Tensor:
    """log of the mixture density (``kl_aggregated.py:22-30``)."""
    return _log_mean_exp(log_likelihood_diagonal_gaussian(
        x[:, None, :], mu[None, :, :], std[None, :, :]))


def log_likelihood_mixture_mixture_gaussian(x, mu_q, std_q, mu_p, std_p,
                                            n_coms: int) -> torch.Tensor:
    """log density of M = (q_agg + p) / 2 as the reference computes it
    (``kl_aggregated.py:32-44``): the q components' log-likelihoods beside
    n_coms copies of p's, then log-mean-exp."""
    res_1 = log_likelihood_diagonal_gaussian(
        x[:, None, :], mu_q[None, :, :], std_q[None, :, :])
    res_2 = log_likelihood_diagonal_gaussian(x, mu_p, std_p)
    return _log_mean_exp(torch.cat(
        [res_1, res_2[:, None].expand(-1, n_coms)], dim=1))


def kl_q_aggregated_p_diagonal_gaussian(idx, eps, q_mean, q_std, p_mean,
                                        p_std) -> torch.Tensor:
    """``kl_aggregated.py:46-51``: z from the aggregated posterior."""
    z = mixture_gaussian(idx, eps, q_mean, q_std)
    log_q = log_likelihood_mixture_gaussian(z, q_mean, q_std)
    log_p = log_likelihood_diagonal_gaussian(z, p_mean, p_std)
    return (log_q - log_p).mean(dim=0)


def ikl_q_aggregated_p_diagonal_gaussian(z_prior, q_mean, q_std, p_mean,
                                         p_std) -> torch.Tensor:
    """``kl_aggregated.py:53-58``: z from the prior."""
    log_q = log_likelihood_mixture_gaussian(z_prior, q_mean, q_std)
    log_p = log_likelihood_diagonal_gaussian(z_prior, p_mean, p_std)
    return (log_p - log_q).mean(dim=0)


def jsd_q_aggregated_p_diagonal_gaussian(idx, eps, z_prior, q_mean, q_std,
                                         p_mean, p_std, n_coms: int
                                         ) -> torch.Tensor:
    """``kl_aggregated.py:60-70``."""
    z1 = mixture_gaussian(idx, eps, q_mean, q_std)
    log_q = log_likelihood_mixture_gaussian(z1, q_mean, q_std)
    log_m1 = log_likelihood_mixture_mixture_gaussian(
        z1, q_mean, q_std, p_mean, p_std, n_coms)
    log_p = log_likelihood_diagonal_gaussian(z_prior, p_mean, p_std)
    log_m2 = log_likelihood_mixture_mixture_gaussian(
        z_prior, q_mean, q_std, p_mean, p_std, n_coms)
    return (0.5 * (log_q - log_m1 + log_p - log_m2)).mean(dim=0)


def vegan_kl(idx, eps, q_mean, q_std, p_mean, p_std, rec_penalty, lamb
             ) -> torch.Tensor:
    """``kl_aggregated.py:83-92``."""
    return lamb * kl_q_aggregated_p_diagonal_gaussian(
        idx, eps, q_mean, q_std, p_mean, p_std) + rec_penalty


def vegan_ikl(z_prior, q_mean, q_std, p_mean, p_std, rec_penalty, lamb
              ) -> torch.Tensor:
    """``kl_aggregated.py:94-103``."""
    return lamb * ikl_q_aggregated_p_diagonal_gaussian(
        z_prior, q_mean, q_std, p_mean, p_std) + rec_penalty


def vegan_jsd(idx, eps, z_prior, q_mean, q_std, p_mean, p_std, rec_penalty,
              n_coms, lamb) -> torch.Tensor:
    """``kl_aggregated.py:72-81``."""
    return lamb * jsd_q_aggregated_p_diagonal_gaussian(
        idx, eps, z_prior, q_mean, q_std, p_mean, p_std, n_coms) \
        + rec_penalty
