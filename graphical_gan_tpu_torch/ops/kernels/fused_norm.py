"""K2: batch-statistics batch norm + activation over channels-last data.

Three kernels in ``csrc/fused_norm.cu``, each behind its own wrapper:

- K2a :func:`bn_stats` replaces ``graphical_gan_tpu/ops/pallas/
  fused_norm.py:_stats``: per-channel mean, biased variance and
  ``inv = 1/sqrt(var + eps)`` of ``[R, C]``, in two deterministic stages
  (per-block Welford partials, then a fixed-order merge by Chan's formula);
- K2b :func:`bn_apply` replaces ``fused_norm.py:_fwd``'s apply pass:
  ``act((x - mean) * (inv * scale) + offset)`` in x's dtype;
- K2c+K2d :func:`bn_bwd` replaces both passes of ``fused_norm.py:_bwd`` in
  one cooperative launch: per channel ``red = [Σgz, Σgz·xhat]`` in f32
  (``gz = g·act'(y)``, xhat and y recomputed from x), one grid-wide
  barrier, then ``dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale`` in x's
  dtype from the g and x each block kept in shared memory. Its work units
  come from :func:`bn_bwd_plan`, a function of the shape alone, and the
  partials merge in a fixed order, so the bits do not depend on the grid.

All three are bound by bytes (see the source). :class:`FusedBatchNormAct`
is the JAX ``fused_batchnorm_act`` with its custom VJP: K2a then K2b
forward, K2c+K2d backward. On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it computes its plain PyTorch version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from graphical_gan_tpu_torch.ops.activations import (
    activation, activation_grad)
from graphical_gan_tpu_torch.ops.kernels import build

EPS = 1e-5
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_STATS_CT = 32      # channels per stats block (csrc ST_CT)
_STATS_RY = 8       # row lanes per stats block (csrc ST_RY)
_STATS_BLOCKS = 528  # stage-1 blocks to aim for: 4 per SM of the H100
_BWD_THREADS = 512   # threads per backward block (csrc kBwdThreads), and
_BWD_THREADS_VEC8 = 256  # where a thread holds 8 bf16 channels
_SMS = 132           # SMs of the H100: the backward aims for a unit on each
_SMEM_MAX = 232448   # dynamic shared memory a block may opt into (227 KB)
_MIN_SEGMENT = 64    # bytes of a row a channel tile covers at the least


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


def _gz_xhat(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
             inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
             act: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gz, xhat) in f32: xhat = (x - mean) * inv, and gz = g * act'(y) with
    y recomputed as K2b computes it, so the mask matches the forward."""
    d = x2d.float() - mean
    y = d * (inv * scale.float()) + offset.float()
    return g2d.float() * activation_grad(act, y), d * inv


def bn_bwd_reduce_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                        mean: torch.Tensor, inv: torch.Tensor,
                        scale: torch.Tensor, offset: torch.Tensor,
                        act: Optional[str] = None) -> torch.Tensor:
    """[Σgz, Σgz·xhat] per column, f32 [2, C]."""
    gz, xhat = _gz_xhat(g2d, x2d, mean, inv, scale, offset, act)
    return torch.stack([gz.sum(dim=0), (gz * xhat).sum(dim=0)])


def bn_bwd_apply_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                       mean: torch.Tensor, inv: torch.Tensor,
                       scale: torch.Tensor, offset: torch.Tensor,
                       red: torch.Tensor, act: Optional[str] = None
                       ) -> torch.Tensor:
    """dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale, in x's dtype."""
    gz, xhat = _gz_xhat(g2d, x2d, mean, inv, scale, offset, act)
    r = x2d.shape[0]
    dx = (gz - red[0] / r - xhat * (red[1] / r)) * inv * scale.float()
    return dx.to(x2d.dtype)


def _chan_f32(x2d: torch.Tensor, *vecs: torch.Tensor):
    c = x2d.shape[1]
    out = [t.to(device=x2d.device, dtype=torch.float32).contiguous()
           for t in vecs]
    if any(t.shape != (c,) for t in out):
        raise ValueError(f"per-channel vectors must be [{c}]")
    return out


def _same_layout(g2d: torch.Tensor, x2d: torch.Tensor, name: str):
    if g2d.shape != x2d.shape:
        raise ValueError(f"{name}: g {tuple(g2d.shape)} and x "
                         f"{tuple(x2d.shape)} differ")
    return g2d.to(x2d.dtype).contiguous()


def bn_bwd_plain(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 act: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, red): :func:`bn_bwd_reduce_plain`, then
    :func:`bn_bwd_apply_plain` with its sums."""
    red = bn_bwd_reduce_plain(g2d, x2d, mean, inv, scale, offset, act)
    return bn_bwd_apply_plain(g2d, x2d, mean, inv, scale, offset, red,
                              act), red


class BwdPlan(NamedTuple):
    """The backward's work units for one shape (:func:`bn_bwd_plan`)."""
    vec: int         # channels per load: 16 bytes' worth, or 1
    tx: int          # lanes across a channel tile (a power of two)
    ty: int          # row lanes: the block's threads // tx
    ct: int          # channels per tile: tx * vec
    n_ct: int        # channel tiles
    rows: int        # rows per row block (a multiple of ty)
    n_rb: int        # row blocks; the last may be ragged
    units: int       # n_rb * n_ct; unit u = (row block u // n_ct, tile u % n_ct)
    grid: int        # blocks: one per SM, fewer where the units are fewer;
                     # block b takes units b, b + grid, ...
    slots: int       # units a block keeps in shared memory
    cache_rows: int  # rows of a unit kept there; the rest is read again
    smem: int        # dynamic shared memory per block, bytes
    onchip: bool     # every row of every unit kept: g and x read once


@functools.lru_cache(maxsize=None)
def bn_bwd_plan(r: int, c: int, dtype: torch.dtype,
                aligned: bool = True) -> BwdPlan:
    """The backward's units for [r, c] in ``dtype``, a function of the shape
    alone (``aligned``: g, x and dx start on 16 bytes, as the caching
    allocator gives them). A block has 512 threads, 256 where each holds 8
    bf16 channels. Channel tiles are the narrowest that still cover
    ``_MIN_SEGMENT`` bytes of a row, widened while there would be more
    tiles than SMs; row blocks then make about one unit per SM, so that
    where there is more than one row block each block takes one unit. A
    block keeps ``cache_rows`` rows of g and x per unit in what shared
    memory is left after the block sums' scratch."""
    size = torch.tensor([], dtype=dtype).element_size()
    full = 16 // size
    vec = full if aligned and c % full == 0 else 1
    threads = _BWD_THREADS_VEC8 if vec == 8 else _BWD_THREADS
    lanes = -(-c // vec)
    top = min(threads, 1 << (lanes - 1).bit_length())
    tx = min(top, max(1, _MIN_SEGMENT // (vec * size)))
    while tx < top and -(-c // (tx * vec)) > _SMS:
        tx *= 2
    ty = threads // tx
    ct = tx * vec
    n_ct = -(-c // ct)
    want = max(1, min(_SMS // n_ct, -(-r // ty)))
    rows = -(-r // want)
    rows = -(-rows // ty) * ty
    n_rb = -(-r // rows)
    units = n_rb * n_ct
    grid = min(units, _SMS)
    slots = -(-units // grid)
    groups = ty // (32 // tx if tx < 32 else 1)
    scratch = (groups + 1) * 2 * ct * 4
    row_bytes = 2 * ct * size  # g and x of one row of a unit
    fit = (_SMEM_MAX - scratch) // (slots * row_bytes) // ty * ty
    cache_rows = min(rows, fit)
    smem = scratch + slots * cache_rows * row_bytes
    return BwdPlan(vec, tx, ty, ct, n_ct, rows, n_rb, units, grid, slots,
                   cache_rows, smem, cache_rows == rows)


def bn_bwd(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
           inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
           act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2c+K2d: (dx of [R, C] in x's dtype, red = [Σgz, Σgz·xhat] f32
    [2, C]) in one launch."""
    if x2d.device.type == "cpu":
        return bn_bwd_plain(g2d, x2d, mean, inv, scale, offset, act)
    _check_2d(x2d, "bn_bwd")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    g2d = _same_layout(g2d, x2d, "bn_bwd")
    chan = _chan_f32(x2d, mean, inv, scale, offset)
    r, c = x2d.shape
    dx = torch.empty_like(x2d)
    aligned = all(t.data_ptr() % 16 == 0 for t in (g2d, x2d, dx))
    p = bn_bwd_plan(r, c, x2d.dtype, aligned)
    f32 = dict(dtype=torch.float32, device=x2d.device)
    part = torch.empty((p.n_rb, 2, c), **f32)
    red = torch.empty((2, c), **f32)
    code = build.lib().ggan_bn_bwd(
        g2d.data_ptr(), x2d.data_ptr(), *[t.data_ptr() for t in chan],
        part.data_ptr(), red.data_ptr(), dx.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, p.vec, p.tx, p.rows,
        p.n_rb, p.slots, p.cache_rows, p.smem, p.grid, build.ACT_CODES[act],
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_bwd")
    bn_bwd.launches += 1
    return dx, red


bn_stats.launches = 0
bn_apply.launches = 0
bn_bwd.launches = 0


def bn_act_backward_plain(g: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor, offset: torch.Tensor,
                          act: Optional[str] = None, eps: float = EPS):
    """(dx, dscale, doffset) of ``act(batchnorm(x))`` at cotangent g, from
    the statistics up, in plain differentiable PyTorch: what autograd
    differentiates for the second-order term, as JAX differentiates its
    ``jnp`` BN twice (``ops/norm.py:84-89``). act' is piecewise constant,
    so its mask carries no gradient."""
    c = x.shape[-1]
    x2d, g2d = x.reshape(-1, c).float(), g.reshape(-1, c).float()
    mean = x2d.mean(dim=0)
    d = x2d - mean
    inv = torch.rsqrt(d.square().mean(dim=0) + eps)
    xhat = d * inv
    y = xhat * scale.float() + offset.float()
    gz = g2d * activation_grad(act, y.detach())
    dgx = (gz * xhat).mean(dim=0)
    dx = (gz - gz.mean(dim=0) - xhat * dgx) * inv * scale.float()
    return (dx.to(x.dtype).reshape(x.shape),
            (gz * xhat).sum(dim=0).to(scale.dtype),
            gz.sum(dim=0).to(offset.dtype))


class _BatchNormActBackward(torch.autograd.Function):
    """The first-order backward of :class:`FusedBatchNormAct` as a function
    of (g, x, scale, offset): K2c+K2d forward. Its own backward, the
    second-order term, differentiates :func:`bn_act_backward_plain` (plain
    PyTorch on both devices; the JAX package has no Pallas kernel for it
    either). A third order raises."""

    @staticmethod
    def forward(ctx, g, x, scale, offset, mean, inv, act, eps):
        c = x.shape[-1]
        x2d, g2d = x.reshape(-1, c), g.reshape(-1, c)
        dx, red = bn_bwd(g2d, x2d, mean, inv, scale, offset, act)
        ctx.save_for_backward(g, x, scale, offset)
        ctx.conf = (act, eps)
        return (dx.reshape(x.shape), red[1].to(scale.dtype),
                red[0].to(offset.dtype))

    @staticmethod
    @once_differentiable
    def backward(ctx, gdx, gdscale, gdoffset):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(ctx.saved_tensors, ctx.needs_input_grad[:4])]
            outs = bn_act_backward_plain(*leaves, *ctx.conf)
            pairs = [(o, go) for o, go in zip(outs, (gdx, gdscale, gdoffset))
                     if go is not None and o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [go for _, go in pairs],
                allow_unused=True) if wrt else ())
        out = [next(grads) if t.requires_grad else None for t in leaves]
        return (*out, None, None, None, None)


class FusedBatchNormAct(torch.autograd.Function):
    """act(batchnorm(x)) over channels-last x with batch statistics, with the
    JAX package's custom VJP (``fused_norm.py:174-236``).

    Forward: K2a then K2b; saves ``(x, scale, offset, mean, inv)`` as
    ``_fwd`` does. Backward: K2c+K2d (:class:`_BatchNormActBackward`);
    ``dx`` in x's dtype, ``dscale = Σgz·xhat`` and ``doffset = Σgz`` in f32,
    cast to the parameters' dtypes. The backward can be differentiated once
    more, as the mnist discriminator's gradient penalty needs: the
    second-order term is plain PyTorch."""

    @staticmethod
    def forward(ctx, x, scale, offset, act, eps):
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        mean, _, inv = bn_stats(x2d, eps)
        y = bn_apply(x2d, mean, inv, scale, offset, act)
        ctx.save_for_backward(x, scale, offset, mean, inv)
        ctx.conf = (act, eps)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, offset, mean, inv = ctx.saved_tensors
        dx, dscale, doffset = _BatchNormActBackward.apply(
            g, x, scale, offset, mean, inv, *ctx.conf)
        return dx, dscale, doffset, None, None


def fused_batchnorm_act(x: torch.Tensor, scale: torch.Tensor,
                        offset: torch.Tensor, act: Optional[str] = None,
                        eps: float = EPS) -> torch.Tensor:
    """act(batchnorm(x)) over channels-last x with batch statistics.

    x: [..., C] contiguous; scale/offset: [C]. Output in x's dtype."""
    return FusedBatchNormAct.apply(x, scale, offset, act, eps)
