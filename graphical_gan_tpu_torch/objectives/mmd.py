"""Maximum mean discrepancy (``graphical_gan_tpu/objectives/mmd.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_DEFAULT_SIGMAS = (2.0, 5.0, 10.0, 20.0, 40.0, 80.0)


def maximum_mean_discrepancy(sample: torch.Tensor, data: torch.Tensor,
                             batch_size: int,
                             sigma: Sequence[float] = _DEFAULT_SIGMAS
                             ) -> torch.Tensor:
    """``mmd.py:4-18``: the kernel is ``exp((xx - x2/2 - x2ᵀ/2) / s)``,
    i.e. exp(-‖a - b‖² / (2s))."""
    x = torch.cat([sample, data], dim=0).float()
    xx = x @ x.T
    x2 = (x * x).sum(dim=1, keepdim=True)
    exponent = xx - 0.5 * x2 - 0.5 * x2.T
    s_all = torch.cat([
        torch.full((sample.shape[0], 1), 1.0 / batch_size, device=x.device),
        torch.full((data.shape[0], 1), -1.0 / batch_size, device=x.device)])
    s_mat = s_all @ s_all.T
    loss = torch.zeros((), device=x.device)
    for s in sigma:
        loss = loss + (s_mat * torch.exp(exponent / s)).sum()
    return torch.sqrt(loss)


def _mix_rbf_kernel(x, y, sigmas, wts=None):
    """``mmd.py:20-41``: gamma = 1 / (2 sigma²) mixture-RBF kernels."""
    if wts is None:
        wts = [1.0] * len(sigmas)
    x, y = x.float(), y.float()
    xx, xy, yy = x @ x.T, x @ y.T, y @ y.T
    x_sq, y_sq = torch.diagonal(xx), torch.diagonal(yy)
    k_xx = k_xy = k_yy = 0.0
    for sigma, wt in zip(sigmas, wts):
        gamma = 1.0 / (2.0 * sigma ** 2)
        k_xx = k_xx + wt * torch.exp(-gamma * (-2 * xx + x_sq[:, None]
                                               + x_sq[None, :]))
        k_xy = k_xy + wt * torch.exp(-gamma * (-2 * xy + x_sq[:, None]
                                               + y_sq[None, :]))
        k_yy = k_yy + wt * torch.exp(-gamma * (-2 * yy + y_sq[:, None]
                                               + y_sq[None, :]))
    return k_xx, k_xy, k_yy, float(sum(wts))


def _mmd2(k_xx, k_xy, k_yy, const_diagonal=False, biased=False
          ) -> torch.Tensor:
    """``mmd.py:43-63``."""
    m = float(k_xx.shape[0])
    n = float(k_yy.shape[0])
    if biased:
        return (k_xx.sum() / (m * m) + k_yy.sum() / (n * n)
                - 2 * k_xy.sum() / (m * n))
    if const_diagonal is not False:
        trace_x, trace_y = m * const_diagonal, n * const_diagonal
    else:
        trace_x, trace_y = torch.trace(k_xx), torch.trace(k_yy)
    return ((k_xx.sum() - trace_x) / (m * (m - 1))
            + (k_yy.sum() - trace_y) / (n * (n - 1))
            - 2 * k_xy.sum() / (m * n))


def mix_rbf_mmd2(x: torch.Tensor, y: torch.Tensor,
                 sigmas: Sequence[float] = _DEFAULT_SIGMAS,
                 wts: Optional[Sequence[float]] = None,
                 biased: bool = True) -> torch.Tensor:
    """``mmd.py:65-67``."""
    k_xx, k_xy, k_yy, d = _mix_rbf_kernel(x, y, sigmas, wts)
    return _mmd2(k_xx, k_xy, k_yy, const_diagonal=d, biased=biased)


def vegan_mmd(q_z: torch.Tensor, p_z: torch.Tensor,
              rec_penalty: torch.Tensor, lamb: float) -> torch.Tensor:
    """Generator-only objective (``mmd.py:69-78``)."""
    return lamb * mix_rbf_mmd2(q_z, p_z) + rec_penalty
