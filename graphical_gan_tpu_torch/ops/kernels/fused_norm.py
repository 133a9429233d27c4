"""K2: batch-statistics batch norm + activation over channels-last data.

Two kernels in ``csrc/fused_norm.cu``, each behind its own wrapper:

- K2a :func:`bn_stats` replaces ``graphical_gan_tpu/ops/pallas/
  fused_norm.py:_stats``: per-channel mean, biased variance and
  ``inv = 1/sqrt(var + eps)`` of ``[R, C]``, in two deterministic stages
  (per-block Welford partials, then a fixed-order merge by Chan's formula);
- K2b :func:`bn_apply` replaces ``fused_norm.py:_fwd``'s apply pass:
  ``act((x - mean) * (inv * scale) + offset)`` in x's dtype.

Both are bound by bytes (see the source). :func:`fused_batchnorm_act` is the
forward of the JAX ``fused_batchnorm_act``: stats then apply over ``x``
reshaped to ``[R, C]``. On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it computes its plain PyTorch version. Forward only:
the backward kernels (``_bwd``) come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.kernels import build

EPS = 1e-5
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_STATS_CT = 32      # channels per stats block (csrc ST_CT)
_STATS_RY = 8       # row lanes per stats block (csrc ST_RY)
_STATS_BLOCKS = 528  # stage-1 blocks to aim for: 4 per SM of the H100


def bn_stats_plain(x2d: torch.Tensor, eps: float = EPS
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased var, 1/sqrt(var + eps)) per column of [R, C], in f32,
    as ``jnp.mean`` / ``jnp.var`` compute them (two passes)."""
    x32 = x2d.float()
    mean = x32.mean(dim=0)
    var = (x32 - mean).square().mean(dim=0)
    return mean, var, torch.rsqrt(var + eps)


def bn_apply_plain(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   act: Optional[str] = None) -> torch.Tensor:
    """act((x - mean) * (inv * scale) + offset) in f32, cast to x's dtype."""
    y = (x2d.float() - mean) * (inv * scale.float()) + offset.float()
    return activation(act)(y).to(x2d.dtype)


def _check_2d(x2d: torch.Tensor, name: str) -> None:
    if x2d.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x2d.device}")
    if x2d.ndim != 2 or not x2d.is_contiguous():
        raise ValueError(f"{name} needs a contiguous [R, C] tensor, got "
                         f"shape {tuple(x2d.shape)}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {x2d.dtype}")
    if x2d.shape[0] == 0 or x2d.shape[1] == 0:
        raise ValueError(f"{name} needs at least one row and one channel")
    if x2d.numel() >= 2 ** 31:
        raise ValueError(f"{name} indexes rows with 32-bit ints")


def stats_split(r: int, c: int) -> Tuple[int, int]:
    """(rows_per_block, n_row_blocks) for stage 1: about ``_STATS_BLOCKS``
    blocks in all, rows a multiple of the row lanes. Depends on the shape
    alone, so the reduction order (and the result's bits) is fixed."""
    ctiles = -(-c // _STATS_CT)
    want = max(1, min(-(-_STATS_BLOCKS // ctiles), -(-r // _STATS_RY)))
    rows = -(-r // want)
    rows = -(-rows // _STATS_RY) * _STATS_RY
    return rows, -(-r // rows)


def bn_stats(x2d: torch.Tensor, eps: float = EPS
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a: (mean, var, inv) per column of [R, C], f32 [C] each."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d, eps)
    _check_2d(x2d, "bn_stats")
    r, c = x2d.shape
    rows, nrb = stats_split(r, c)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    part = torch.empty((2, nrb, c), **f32)
    out = torch.empty((3, c), **f32)
    code = build.lib().ggan_bn_stats(
        x2d.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, rows, nrb, float(eps),
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_stats")
    bn_stats.launches += 1
    return out[0], out[1], out[2]


def bn_apply(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             scale: torch.Tensor, offset: torch.Tensor,
             act: Optional[str] = None) -> torch.Tensor:
    """K2b: act((x - mean) * (inv * scale) + offset), output in x's dtype."""
    if x2d.device.type == "cpu":
        return bn_apply_plain(x2d, mean, inv, scale, offset, act)
    _check_2d(x2d, "bn_apply")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    r, c = x2d.shape
    chan = [t.to(device=x2d.device, dtype=torch.float32).contiguous()
            for t in (mean, inv, scale, offset)]
    if any(t.shape != (c,) for t in chan):
        raise ValueError(f"bn_apply: per-channel vectors must be [{c}]")
    y = torch.empty_like(x2d)
    aligned = x2d.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    vec = 4 if c % 4 == 0 and aligned else 1
    code = build.lib().ggan_bn_apply(
        x2d.data_ptr(), *[t.data_ptr() for t in chan], y.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], x2d.numel(), c,
        build.ACT_CODES[act], vec, build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_apply")
    bn_apply.launches += 1
    return y


bn_stats.launches = 0
bn_apply.launches = 0


def fused_batchnorm_act(x: torch.Tensor, scale: torch.Tensor,
                        offset: torch.Tensor, act: Optional[str] = None,
                        eps: float = EPS) -> torch.Tensor:
    """act(batchnorm(x)) over channels-last x with batch statistics.

    x: [..., C] contiguous; scale/offset: [C]. Output in x's dtype."""
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    mean, _, inv = bn_stats(x2d, eps)
    return bn_apply(x2d, mean, inv, scale, offset, act).reshape(x.shape)
