"""K2: batch-statistics batch norm + activation over channels-last data.

Three kernels in ``csrc/fused_norm.cu``, each behind its own wrapper:

- K2a :func:`bn_stats` replaces ``graphical_gan_tpu/ops/pallas/
  fused_norm.py:_stats`` in one cooperative launch: per-channel mean,
  biased variance and ``inv = 1/sqrt(var + eps)`` of ``[R, C]``. x is read
  once; each unit sums ``d = x - x[0, c]`` and ``d²`` in f64, writes its
  ``(mean, M2)``, and after one grid-wide barrier the partials merge per
  channel in row-block order by Chan's formula, in f64, so that mean and
  var are the f32 roundings of the exact statistics up to an f64
  rounding;
- K2b :func:`bn_apply` replaces ``fused_norm.py:_fwd``'s apply pass:
  ``act((x - mean) * (inv * scale) + offset)`` in x's dtype;
  :func:`bn_apply_q8` is the same kernel with a second output, y's int8
  copy at its consumer's scale (Q1 folded into its producer, for the int8
  serving path: ``ops/quant.py``);
- K2c+K2d :func:`bn_bwd` replaces both passes of ``fused_norm.py:_bwd`` in
  one cooperative launch: per channel ``red = [Σgz, Σgz·xhat]`` in f32
  (``gz = g·act'(y)``, xhat and y recomputed from x), one grid-wide
  barrier, then ``dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale`` in x's
  dtype from the g and x each block kept in shared memory.

Split modes, for batch statistics over the rows of several ranks
(``parallel/``: DP, SP): a grid barrier cannot wait for another process,
so each kernel's two phases become two steps with the cross-rank sums
between them. K2a with K2b: :func:`bn_stats_local` (one cluster launch:
the rank's f64 (n, mean, M2), unshifted, written into the rank's slot of
the [W, 3, C] exchange buffer, zeros in the others), one ``all_reduce``
of that buffer (``parallel/collectives.py: all_reduce_stack``), then
:func:`bn_apply_split` (K2b with the finalize, Chan's merge of the W
triples in rank order, folded in; it also writes the [3, C] (mean, var,
inv) the backward saves), or :func:`bn_apply_split_q8` for the int8
server: two launches for a BN forward. K2c+K2d: :func:`bn_bwd_local`
(one cluster launch: the rank's f32 [Σgz, Σgz·xhat] written into its slot
of the [W, 2, C] exchange buffer, zeros in the others), one
``all_reduce`` of that buffer, then :func:`bn_bwd_apply_split` (K2d with
the ranks' sums added in rank order folded in, dx over the group's rows):
two launches for a BN backward. At one rank the one-launch kernels run as
before.

K2a's and K2c+K2d's work units come from one tiling (:func:`_unit_tiling`,
a function of the shape alone; :func:`bn_stats_plan`, :func:`bn_bwd_plan`)
and their partials merge in a fixed order, so the bits do not depend on
the grid. All three are bound by bytes (see the source).
:class:`FusedBatchNormAct` is the JAX ``fused_batchnorm_act`` with its
custom VJP: K2a then K2b forward, K2c+K2d backward. On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it computes its
plain PyTorch version. On CUDA, K2a and K2b run as the ops
``ggan::bn_stats`` and ``ggan::bn_apply`` (``torch.library.custom_op``s), so
``torch.export`` traces a serving entry through them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from graphical_gan_tpu_torch.ops.activations import (
    activation, activation_grad)
from graphical_gan_tpu_torch.ops.kernels import build
from graphical_gan_tpu_torch.ops.kernels.quant import quantize_int8_plain

EPS = 1e-5
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_THREADS = 512       # threads per K2a and K2c+K2d block (csrc kThreads),
_THREADS_VEC8 = 256  # and where a thread holds 8 bf16 channels
_SMS = 132           # SMs of the H100: the plans aim for a unit on each
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


class UnitPlan(NamedTuple):
    """K2a's or K2c+K2d's work units for one shape (:func:`bn_stats_plan`,
    :func:`bn_bwd_plan`)."""
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
    slots: int       # units a block takes
    cache_rows: int  # K2c+K2d: rows of a unit kept in shared memory (the
                     # rest is read again); K2a keeps none
    smem: int        # dynamic shared memory per block, bytes
    onchip: bool     # K2c+K2d: every row of every unit kept, g and x read
                     # once


def _unit_tiling(r: int, c: int, dtype: torch.dtype,
                 aligned: bool) -> UnitPlan:
    """The units of [r, c] in ``dtype`` that K2a and K2c+K2d share, a
    function of the shape alone (``aligned``: the tensors start on 16
    bytes, as the caching allocator gives them), with nothing kept in
    shared memory yet. A block has 512 threads, 256 where each holds 8
    bf16 channels. Channel tiles are the narrowest that still cover
    ``_MIN_SEGMENT`` bytes of a row, widened while there would be more
    tiles than SMs; row blocks then make about one unit per SM, so that
    where there is more than one row block each block takes one unit."""
    size = dtype.itemsize
    full = 16 // size
    vec = full if aligned and c % full == 0 else 1
    threads = _THREADS_VEC8 if vec == 8 else _THREADS
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
    return UnitPlan(vec, tx, ty, ct, n_ct, rows, n_rb, units, grid,
                    -(-units // grid), 0, 0, False)


def _block_sum_bytes(p, values: int, size: int) -> int:
    """The scratch of csrc block_sum over ``values`` per channel of
    ``size`` bytes at plan ``p``'s lanes (a :class:`UnitPlan` or a
    :class:`LocalPlan`): a row per warp's group of row lanes, and one for
    the totals."""
    groups = p.ty // (32 // p.tx if p.tx < 32 else 1)
    return (groups + 1) * values * p.ct * size


@functools.lru_cache(maxsize=None)
def bn_stats_plan(r: int, c: int, dtype: torch.dtype,
                  aligned: bool = True) -> UnitPlan:
    """K2a's units for [r, c] in ``dtype`` (``aligned``: x starts on 16
    bytes). K2a reads each row once and keeps none: its shared memory
    holds the block sum's scratch (two f64 values a channel) and, where
    there is more than one row block, the staged f64 partials of one
    channel tile ((mean, M2) of each row block) with the merge's two
    weights per row block."""
    p = _unit_tiling(r, c, dtype, aligned)
    staged = p.n_rb * 2 * (p.ct + 1) * 8 if p.n_rb > 1 else 0
    return p._replace(smem=_block_sum_bytes(p, 2, 8) + staged)


@functools.lru_cache(maxsize=None)
def bn_bwd_plan(r: int, c: int, dtype: torch.dtype,
                aligned: bool = True) -> UnitPlan:
    """K2c+K2d's units for [r, c] in ``dtype`` (``aligned``: g, x and dx
    start on 16 bytes). A block keeps every unit it takes (``slots``),
    ``cache_rows`` rows of g and x each, in what shared memory is left
    after the block sum's scratch (two values a channel)."""
    p = _unit_tiling(r, c, dtype, aligned)
    scratch = _block_sum_bytes(p, 2, 4)
    row_bytes = 2 * p.ct * dtype.itemsize  # g and x of one row of a unit
    fit = (_SMEM_MAX - scratch) // (p.slots * row_bytes) // p.ty * p.ty
    cache_rows = min(p.rows, fit)
    return p._replace(cache_rows=cache_rows,
                      smem=scratch + p.slots * cache_rows * row_bytes,
                      onchip=cache_rows == p.rows)


def bn_stats(x2d: torch.Tensor, eps: float = EPS
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2a: (mean, var, inv) per column of [R, C], f32 [C] each, views of
    one [3, C] tensor, in one launch. On CUDA it runs as the op
    ``ggan::bn_stats``."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d, eps)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bn_stats: no kernel for {x2d.device}")
    out = build.run_op(_k2a, _k2a_cuda, x2d, float(eps))
    return out[0], out[1], out[2]


@torch.library.custom_op("ggan::bn_stats", mutates_args=(),
                         device_types="cpu")
def _k2a(x2d: torch.Tensor, eps: float) -> torch.Tensor:
    """K2a on a CPU tensor (a program exported on the card, run on the
    CPU): the plain version, as one [3, C] tensor."""
    return torch.stack(bn_stats_plain(x2d, eps))


@_k2a.register_fake
def _k2a_fake(x2d, eps):
    return x2d.new_empty((3, x2d.shape[1]), dtype=torch.float32)


@_k2a.register_kernel("cuda")
def _k2a_cuda(x2d, eps):
    _check_2d(x2d, "bn_stats")
    r, c = x2d.shape
    p = bn_stats_plan(r, c, x2d.dtype, x2d.data_ptr() % 16 == 0)
    # one allocation: the units' (mean, M2) partials in f64, [n_rb, 2, C]
    # (written where n_rb > 1), then mean, var and inv
    buf = torch.empty((4 * p.n_rb + 3) * c, dtype=torch.float32,
                      device=x2d.device)
    out = buf[4 * p.n_rb * c:].view(3, c)
    code = build.lib().ggan_bn_stats(
        x2d.data_ptr(), buf.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, p.vec, p.tx, p.rows,
        p.n_rb, p.smem, p.grid, float(eps), build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_stats")
    bn_stats.launches += 1
    return out


def bn_apply(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             scale: torch.Tensor, offset: torch.Tensor,
             act: Optional[str] = None) -> torch.Tensor:
    """K2b: act((x - mean) * (inv * scale) + offset), output in x's dtype.
    On CUDA it runs as the op ``ggan::bn_apply``."""
    if x2d.device.type == "cpu":
        return bn_apply_plain(x2d, mean, inv, scale, offset, act)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bn_apply: no kernel for {x2d.device}")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return build.run_op(_k2b, _k2b_cuda, x2d, mean, inv, scale, offset,
                        act or "")


@torch.library.custom_op("ggan::bn_apply", mutates_args=(),
                         device_types="cpu")
def _k2b(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
         scale: torch.Tensor, offset: torch.Tensor, act: str
         ) -> torch.Tensor:
    """K2b on a CPU tensor (a program exported on the card, run on the
    CPU): the plain version."""
    return bn_apply_plain(x2d, mean, inv, scale, offset, act or None)


@_k2b.register_fake
def _k2b_fake(x2d, mean, inv, scale, offset, act):
    return torch.empty_like(x2d)


@_k2b.register_kernel("cuda")
def _k2b_cuda(x2d, mean, inv, scale, offset, act):
    act = act or None
    _check_2d(x2d, "bn_apply")
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


def bn_apply_q8_plain(x2d: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor, act: Optional[str],
                      s_x: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, q): K2b's y and Q1 of it at ``s_x``, as two passes."""
    y = bn_apply_plain(x2d, mean, inv, scale, offset, act)
    return y, quantize_int8_plain(y, s_x)


def bn_apply_q8(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                scale: torch.Tensor, offset: torch.Tensor,
                act: Optional[str], s_x: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b with its int8 copy: y as :func:`bn_apply` gives it (the same
    bits) and ``q = clip(rint(f32(y) / f32(s_x)), -127, 127)`` as int8,
    Q1's values, in one pass. On CUDA it runs as the op
    ``ggan::bn_apply_q8``."""
    if x2d.device.type == "cpu":
        return bn_apply_q8_plain(x2d, mean, inv, scale, offset, act, s_x)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bn_apply_q8: no kernel for {x2d.device}")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return build.run_op(_k2b_q8, _k2b_q8_cuda, x2d, mean, inv, scale, offset,
                        act or "", float(s_x))


@torch.library.custom_op("ggan::bn_apply_q8", mutates_args=(),
                         device_types="cpu")
def _k2b_q8(x2d: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
            scale: torch.Tensor, offset: torch.Tensor, act: str, s_x: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b with its int8 copy on a CPU tensor: the plain version."""
    return bn_apply_q8_plain(x2d, mean, inv, scale, offset, act or None, s_x)


@_k2b_q8.register_fake
def _k2b_q8_fake(x2d, mean, inv, scale, offset, act, s_x):
    return torch.empty_like(x2d), torch.empty_like(x2d, dtype=torch.int8)


@_k2b_q8.register_kernel("cuda")
def _k2b_q8_cuda(x2d, mean, inv, scale, offset, act, s_x):
    act = act or None
    _check_2d(x2d, "bn_apply_q8")
    r, c = x2d.shape
    chan = [t.to(device=x2d.device, dtype=torch.float32).contiguous()
            for t in (mean, inv, scale, offset)]
    if any(t.shape != (c,) for t in chan):
        raise ValueError(f"bn_apply_q8: per-channel vectors must be [{c}]")
    y = torch.empty_like(x2d)
    q = torch.empty_like(x2d, dtype=torch.int8)
    aligned = (x2d.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
               and q.data_ptr() % 4 == 0)
    vec = 4 if c % 4 == 0 and aligned else 1
    code = build.lib().ggan_bn_apply_q8(
        x2d.data_ptr(), *[t.data_ptr() for t in chan], y.data_ptr(),
        q.data_ptr(), float(s_x), build.DTYPE_CODES[_DTYPES[x2d.dtype]],
        x2d.numel(), c, build.ACT_CODES[act], vec,
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_apply_q8")
    bn_apply_q8.launches += 1
    return y, q


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
                       red: torch.Tensor, act: Optional[str] = None,
                       rows: Optional[int] = None) -> torch.Tensor:
    """dx = (gz - Σgz/R - xhat·Σ(gz·xhat)/R)·inv·scale, in x's dtype; R is
    ``rows`` where the sums in ``red`` run over more rows than x's (the
    split mode's phase 2), else x's rows."""
    gz, xhat = _gz_xhat(g2d, x2d, mean, inv, scale, offset, act)
    r = x2d.shape[0] if rows is None else int(rows)
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


# -- split modes: batch statistics over the rows of several ranks ----------


def bn_stats_local_plain(x2d: torch.Tensor, index: int = 0,
                         world: Optional[int] = None) -> torch.Tensor:
    """[3, C] f64: the rows' count n, mean and M2 = Σ(x - mean)² per
    column, unshifted (each rank's own ``x[0, c]`` shift would differ).
    With ``world``, the slot form: the [world, 3, C] exchange buffer with
    the triple in slot ``index`` and zeros in the others."""
    x64 = x2d.double()
    mean = x64.mean(dim=0)
    m2 = (x64 - mean).square().sum(dim=0)
    triple = torch.stack([torch.full_like(mean, float(x2d.shape[0])), mean,
                          m2])
    if world is None:
        return triple
    out = triple.new_zeros((int(world),) + tuple(triple.shape))
    out[index] = triple
    return out


def bn_stats_merge_plain(parts: torch.Tensor, eps: float = EPS
                         ) -> torch.Tensor:
    """[3, C] f32 (mean, var, inv) of the ranks' [W, 3, C] f64 (n, mean,
    M2), merged in rank order by Chan's formula in f64; mean and var are
    rounded once to f32 and inv is taken in f32 from the rounded var, as
    K2a's one launch writes them. The reference of the finalize that
    :func:`bn_apply_split` folds in."""
    n, mean, m2 = parts[0, 0], parts[0, 1], parts[0, 2]
    for r in range(1, parts.shape[0]):
        nb, mb, m2b = parts[r, 0], parts[r, 1], parts[r, 2]
        tot = n + nb
        fb = nb / tot
        d = mb - mean
        mean = mean + d * fb
        m2 = m2 + m2b + d * d * (n * fb)
        n = tot
    var = (m2 / n).float()
    return torch.stack([mean.float(), var, torch.rsqrt(var + eps)])


class LocalPlan(NamedTuple):
    """:func:`bn_stats_local`'s or :func:`bn_bwd_local`'s launch for one
    shape (:func:`bn_stats_local_plan`, :func:`bn_bwd_local_plan`): one
    thread-block cluster per channel tile, its blocks over the tile's
    rows."""
    vec: int      # channels per load: 16 bytes' worth, or 1
    tx: int       # lanes across a channel tile (a power of two)
    ty: int       # row lanes: the block's threads // tx
    ct: int       # channels per tile: tx * vec
    n_ct: int     # channel tiles, one cluster each
    rows: int     # rows per block (a multiple of ty); the last block's may
                  # be ragged
    cluster: int  # blocks per cluster (the plan's at most _CLUSTER_MAX)
    smem: int     # dynamic shared memory per block, bytes


# blocks of a cluster the local plans take at most. The kernels take up to
# 16 (the non-portable size), but at 512 threads and 96 registers a block
# holds its SM alone, and too few of the H100's GPCs hold 16 such blocks at
# once: at 2,048 rows of 8 tiles, clusters of 16 took 0.0124 ms against
# 0.0072 at 8 in bn_stats_local, 0.0089 against 0.0060 in bn_bwd_local
# (PERF.md §6, tools/sweep_stats_local.py)
_CLUSTER_MAX = 8


@functools.lru_cache(maxsize=None)
def bn_stats_local_plan(r: int, c: int, dtype: torch.dtype,
                        aligned: bool = True) -> LocalPlan:
    """The launch of :func:`bn_stats_local` for [r, c] in ``dtype``
    (``aligned``: x starts on 16 bytes), a function of the shape alone:
    channel tiles as :func:`_unit_tiling` cuts them, each tile's rows cut
    over a cluster of up to ``_CLUSTER_MAX`` blocks (:func:`local_plan_at`).
    G.BN1's 32 rows a rank take a cluster of 1, G.BN3's 8,192 rows of 64
    channels fill it."""
    u = _unit_tiling(r, c, dtype, aligned)
    return local_plan_at(r, c, u.vec, u.tx, u.tx * u.ty, _CLUSTER_MAX)


def local_plan_at(r: int, c: int, vec: int, tx: int, threads: int,
                  most: int) -> LocalPlan:
    """The :class:`LocalPlan` of [r, c] at ``vec`` channels a load, ``tx``
    lanes across a tile of a ``threads``-thread block and clusters of at
    most ``most`` blocks: as many blocks as keep the clusters within one
    block per SM and every block's row lanes busy. Shared memory: the
    block sum's scratch (two f64 values a channel), the cluster's (mean,
    M2) of the tile (block 0 gathers the others'), the shift and the
    merge's two weights a block. ``tools/sweep_stats_local.py`` times
    other lanes and limits through it."""
    ty = threads // tx
    ct = tx * vec
    n_ct = -(-c // ct)
    want = max(1, min(most, _SMS // n_ct, -(-r // ty)))
    rows = -(-(-(-r // want)) // ty) * ty
    cluster = -(-r // rows)
    groups = ty // (32 // tx if tx < 32 else 1)
    smem = ((groups + 1) * 2 * ct + cluster * 2 * ct + ct + 2 * cluster) * 8
    return LocalPlan(vec, tx, ty, ct, n_ct, rows, cluster, smem)


class SplitApplyPlan(NamedTuple):
    """:func:`bn_apply_split`'s or :func:`bn_bwd_apply_split`'s grid for
    one shape (:func:`bn_apply_split_plan`, :func:`bn_bwd_apply_split_plan`):
    blocks of 256 threads over (channel tile, row range)."""
    vec: int   # channels per load: 16 bytes' worth, or 1
    tx: int    # lanes across a channel tile (a power of two)
    ty: int    # row lanes: 256 // tx
    ct: int    # channels per tile: tx * vec
    n_ct: int  # channel tiles
    rows: int  # rows per block (a multiple of ty); the last may be ragged
    n_rr: int  # row ranges
    smem: int  # shared memory per block: its per-channel f32 values


_APPLY_THREADS = 256
_APPLY_BLOCKS = 4 * _SMS  # blocks the row ranges aim for at most
_REREAD_SHARE = 10        # the ranks' values read past the first row range:
                          # < 1/10 of the rows' bytes
_SECTOR = 32              # bytes of a row a tile covers at the least


def _split_apply_grid(r: int, c: int, dtype: torch.dtype, row_bytes: int,
                      reread: int, values: int, aligned: bool
                      ) -> SplitApplyPlan:
    """The (channel tile, row range) grid of a split-mode apply over [r, c]
    in ``dtype``, a function of the shape alone: every block reads its
    tile's ranks' values again (``reread`` bytes a channel), so the row
    ranges are few enough that the reads past the first stay under a
    tenth of the ``row_bytes`` a row and channel the kernel reads:
    (n_rr - 1)·reread < r·row_bytes / 10. Tiles start at 64 bytes of a row,
    wider where the rows are fewer than a block's row lanes (G.BN1's 32
    rows), narrower, down to one 32-byte sector, while the blocks would not
    fill the SMs. ``values`` f32 a channel go to shared memory."""
    size = dtype.itemsize
    full = 16 // size
    vec = full if aligned and c % full == 0 else 1
    lanes = -(-c // vec)
    top = min(_APPLY_THREADS, 1 << (lanes - 1).bit_length())
    max_rr = 1 + (r * row_bytes - 1) // (_REREAD_SHARE * reread)

    def grid(tx):
        ty = _APPLY_THREADS // tx
        n_ct = -(-lanes // tx)
        want = max(1, min(max_rr, -(-r // ty), -(-_APPLY_BLOCKS // n_ct)))
        rows = -(-(-(-r // want)) // ty) * ty
        return ty, n_ct, rows, -(-r // rows)

    tx = min(top, max(1, _MIN_SEGMENT // (vec * size)))
    while tx < top and _APPLY_THREADS // tx > r:
        tx *= 2
    ty, n_ct, rows, n_rr = grid(tx)
    while (n_ct * n_rr < _SMS and tx > 1 and tx * vec * size > _SECTOR
           and 2 * ty <= r):
        tx //= 2
        ty, n_ct, rows, n_rr = grid(tx)
    return SplitApplyPlan(vec, tx, ty, tx * vec, n_ct, rows, n_rr,
                          values * tx * vec * 4)


@functools.lru_cache(maxsize=None)
def bn_apply_split_plan(r: int, c: int, dtype: torch.dtype, world: int,
                        aligned: bool = True) -> SplitApplyPlan:
    """:func:`bn_apply_split`'s grid for [r, c] in ``dtype`` over
    ``world`` ranks' triples (``aligned``: x and y start on 16 bytes, an
    int8 copy on 16 / itemsize): :func:`_split_apply_grid` with the
    triples (24 bytes a rank and channel) read again against x's bytes;
    mean, inv·scale and offset in shared memory."""
    return _split_apply_grid(r, c, dtype, dtype.itemsize, 24 * world, 3,
                             aligned)


def launch_stats_local(x2d: torch.Tensor, p: LocalPlan, index: int,
                       world: int) -> torch.Tensor:
    """Launch ggan_bn_stats_local on CUDA ``x2d`` at plan ``p``: the
    [world, 3, C] f64 exchange buffer, the rows' (n, mean, M2) in slot
    ``index`` and zeros in the others. Counts nothing:
    :func:`bn_stats_local` is the wrapper."""
    _check_2d(x2d, "bn_stats_local")
    if not 0 <= index < world:
        raise ValueError(f"bn_stats_local: slot {index} of {world}")
    r, c = x2d.shape
    out = torch.empty((world, 3, c), dtype=torch.float64, device=x2d.device)
    code = build.lib().ggan_bn_stats_local(
        x2d.data_ptr(), out.data_ptr(), build.DTYPE_CODES[_DTYPES[x2d.dtype]],
        r, c, p.vec, p.tx, p.rows, p.cluster, p.smem, index, world,
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_stats_local")
    return out


def bn_stats_local(x2d: torch.Tensor, index: int, world: int
                   ) -> torch.Tensor:
    """K2a's split mode, the rank's statistics: the [world, 3, C] f64
    exchange buffer with the rows' count n, mean and M2 per column of
    [R, C] in slot ``index`` (its row blocks merged in the launch, then
    the shift added back to the mean) and zeros elsewhere. One
    non-cooperative cluster launch (:func:`bn_stats_local_plan`)."""
    if x2d.device.type == "cpu":
        return bn_stats_local_plain(x2d, index, world)
    r, c = x2d.shape
    out = launch_stats_local(
        x2d, bn_stats_local_plan(r, c, x2d.dtype, x2d.data_ptr() % 16 == 0),
        index, int(world))
    bn_stats_local.launches += 1
    return out


def bn_stats_exchange(x2d: torch.Tensor, group) -> torch.Tensor:
    """The [W, 3, C] f64 triples of every rank of ``group``, in rank order,
    the same bits on every rank: :func:`bn_stats_local` in the slot form,
    then one ``all_reduce`` of the buffer."""
    from graphical_gan_tpu_torch.parallel.collectives import (
        all_reduce_stack)
    return all_reduce_stack(
        bn_stats_local(x2d, group.index, group.size), group)


def bn_apply_split_plain(x2d: torch.Tensor, parts: torch.Tensor,
                         scale: torch.Tensor, offset: torch.Tensor,
                         act: Optional[str] = None, eps: float = EPS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): the finalize (:func:`bn_stats_merge_plain` of the
    ranks' [W, 3, C] triples) then :func:`bn_apply_plain` at its mean and
    inv; stats is [3, C] f32 (mean, var, inv)."""
    stats = bn_stats_merge_plain(parts, eps)
    return bn_apply_plain(x2d, stats[0], stats[2], scale, offset,
                          act), stats


def bn_apply_split_q8_plain(x2d: torch.Tensor, parts: torch.Tensor,
                            scale: torch.Tensor, offset: torch.Tensor,
                            act: Optional[str], s_x: float,
                            eps: float = EPS
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(y, q, stats): the finalize then :func:`bn_apply_q8_plain`."""
    stats = bn_stats_merge_plain(parts, eps)
    y, q = bn_apply_q8_plain(x2d, stats[0], stats[2], scale, offset, act,
                             s_x)
    return y, q, stats


def _apply_split(name, x2d, parts, scale, offset, act, eps, s_x=None):
    """Launch ggan_bn_apply_split: (y, q or None, stats)."""
    _check_2d(x2d, name)
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    r, c = x2d.shape
    if parts.dtype != torch.float64 or parts.ndim != 3 \
            or parts.shape[1:] != (3, c) or parts.device != x2d.device:
        raise ValueError(f"{name} takes the ranks' [W, 3, {c}] f64 triples "
                         f"on {x2d.device}, got {parts.dtype} "
                         f"{tuple(parts.shape)} on {parts.device}")
    parts = parts.contiguous()
    scale, offset = _chan_f32(x2d, scale, offset)
    y = torch.empty_like(x2d)
    q = None if s_x is None else torch.empty_like(x2d, dtype=torch.int8)
    stats = torch.empty((3, c), dtype=torch.float32, device=x2d.device)
    vec = 16 // x2d.dtype.itemsize
    aligned = (x2d.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
               and (q is None or q.data_ptr() % vec == 0))
    p = bn_apply_split_plan(r, c, x2d.dtype, parts.shape[0], aligned)
    code = build.lib().ggan_bn_apply_split(
        x2d.data_ptr(), parts.data_ptr(), scale.data_ptr(),
        offset.data_ptr(), y.data_ptr(), stats.data_ptr(),
        None if q is None else q.data_ptr(),
        1.0 if s_x is None else float(s_x),
        build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, parts.shape[0], p.vec,
        p.tx, p.rows, p.n_rr, p.smem, float(eps), build.ACT_CODES[act],
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_apply_split")
    return y, q, stats


def bn_apply_split(x2d: torch.Tensor, parts: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   act: Optional[str] = None, eps: float = EPS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b in the split mode with K2a's finalize folded in: (y, stats)
    from the ranks' gathered [W, 3, C] f64 triples
    (:func:`bn_stats_exchange`). Each block merges its channel tile's
    triples in rank order (:func:`bn_stats_merge_plain`'s arithmetic) and
    applies as :func:`bn_apply` does: y is K2b's at the [3, C] f32 (mean,
    var, inv) it also writes. One launch."""
    if x2d.device.type == "cpu":
        return bn_apply_split_plain(x2d, parts, scale, offset, act, eps)
    y, _, stats = _apply_split("bn_apply_split", x2d, parts, scale, offset,
                               act, eps)
    bn_apply_split.launches += 1
    return y, stats


def bn_apply_split_q8(x2d: torch.Tensor, parts: torch.Tensor,
                      scale: torch.Tensor, offset: torch.Tensor,
                      act: Optional[str], s_x: float, eps: float = EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bn_apply_split` with y's int8 copy at ``s_x`` as
    :func:`bn_apply_q8` writes it: (y, q, stats), one launch (the dp int8
    server)."""
    if x2d.device.type == "cpu":
        return bn_apply_split_q8_plain(x2d, parts, scale, offset, act, s_x,
                                       eps)
    y, q, stats = _apply_split("bn_apply_split_q8", x2d, parts, scale,
                               offset, act, eps, s_x)
    bn_apply_split_q8.launches += 1
    return y, q, stats


@functools.lru_cache(maxsize=None)
def bn_bwd_local_plan(r: int, c: int, dtype: torch.dtype,
                      aligned: bool = True) -> LocalPlan:
    """The launch of :func:`bn_bwd_local` for [r, c] in ``dtype``
    (``aligned``: g and x start on 16 bytes), a function of the shape
    alone: channel tiles as :func:`_unit_tiling` cuts them, each tile's
    rows cut over a cluster of up to ``_CLUSTER_MAX`` blocks
    (:func:`bwd_local_plan_at`)."""
    u = _unit_tiling(r, c, dtype, aligned)
    return bwd_local_plan_at(r, c, u.vec, u.tx, u.tx * u.ty, _CLUSTER_MAX)


def bwd_local_plan_at(r: int, c: int, vec: int, tx: int, threads: int,
                      most: int) -> LocalPlan:
    """:func:`local_plan_at`'s tiles and clusters, with the shared memory
    of :func:`bn_bwd_local`: the block sum's scratch (two f32 values a
    channel) and the cluster's sums of the tile, which the blocks store
    into block 0's."""
    p = local_plan_at(r, c, vec, tx, threads, most)
    return p._replace(smem=_block_sum_bytes(p, 2, 4)
                      + p.cluster * 2 * p.ct * 4)


@functools.lru_cache(maxsize=None)
def bn_bwd_apply_split_plan(r: int, c: int, dtype: torch.dtype, world: int,
                            aligned: bool = True) -> SplitApplyPlan:
    """:func:`bn_bwd_apply_split`'s grid for [r, c] in ``dtype`` over
    ``world`` ranks' sums (``aligned``: g, x and dx start on 16 bytes):
    :func:`_split_apply_grid` with the [world, 2, C] f32 sums (8 bytes a
    rank and channel) read again against g's and x's bytes; mean,
    inv·scale, offset, Σgz/N and inv·Σ(gz·xhat)/N in shared memory."""
    return _split_apply_grid(r, c, dtype, 2 * dtype.itemsize, 8 * world, 5,
                             aligned)


def bn_bwd_local_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                       mean: torch.Tensor, inv: torch.Tensor,
                       scale: torch.Tensor, offset: torch.Tensor, index: int,
                       world: int, act: Optional[str] = None) -> torch.Tensor:
    """The [world, 2, C] f32 exchange buffer: :func:`bn_bwd_reduce_plain`'s
    [Σgz, Σgz·xhat] of the rows in slot ``index``, zeros in the others."""
    if not 0 <= index < world:
        raise ValueError(f"bn_bwd_local: slot {index} of {world}")
    red = bn_bwd_reduce_plain(g2d, x2d, mean, inv, scale, offset, act)
    out = red.new_zeros((int(world),) + tuple(red.shape))
    out[index] = red
    return out


def launch_bwd_local(g2d: torch.Tensor, x2d: torch.Tensor,
                     mean: torch.Tensor, inv: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor,
                     act: Optional[str], p: LocalPlan, index: int,
                     world: int) -> torch.Tensor:
    """Launch ggan_bn_bwd_local on CUDA ``g2d`` and ``x2d`` at plan ``p``:
    the [world, 2, C] f32 exchange buffer, the rows' sums in slot
    ``index`` and zeros in the others. Counts nothing:
    :func:`bn_bwd_local` is the wrapper."""
    _check_2d(x2d, "bn_bwd_local")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if not 0 <= index < world:
        raise ValueError(f"bn_bwd_local: slot {index} of {world}")
    g2d = _same_layout(g2d, x2d, "bn_bwd_local")
    chan = _chan_f32(x2d, mean, inv, scale, offset)
    r, c = x2d.shape
    out = torch.empty((world, 2, c), dtype=torch.float32, device=x2d.device)
    code = build.lib().ggan_bn_bwd_local(
        g2d.data_ptr(), x2d.data_ptr(), *[t.data_ptr() for t in chan],
        out.data_ptr(), build.DTYPE_CODES[_DTYPES[x2d.dtype]], r, c, p.vec,
        p.tx, p.rows, p.cluster, p.smem, build.ACT_CODES[act], index, world,
        build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_bwd_local")
    return out


def bn_bwd_local(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 index: int, world: int, act: Optional[str] = None
                 ) -> torch.Tensor:
    """K2c's split mode, the rank's sums: the [world, 2, C] f32 exchange
    buffer with [Σgz, Σgz·xhat] per column of [R, C] in slot ``index``
    (its blocks' sums added in block order in the launch) and zeros
    elsewhere. One non-cooperative cluster launch
    (:func:`bn_bwd_local_plan`)."""
    if x2d.device.type == "cpu":
        return bn_bwd_local_plain(g2d, x2d, mean, inv, scale, offset, index,
                                  world, act)
    g2d = _same_layout(g2d, x2d, "bn_bwd_local")
    r, c = x2d.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (g2d, x2d))
    out = launch_bwd_local(g2d, x2d, mean, inv, scale, offset, act,
                           bn_bwd_local_plan(r, c, x2d.dtype, aligned),
                           index, int(world))
    bn_bwd_local.launches += 1
    return out


def bn_bwd_apply_split_plain(g2d: torch.Tensor, x2d: torch.Tensor,
                             mean: torch.Tensor, inv: torch.Tensor,
                             scale: torch.Tensor, offset: torch.Tensor,
                             sums: torch.Tensor, rows: int,
                             act: Optional[str] = None) -> torch.Tensor:
    """dx from the ranks' [W, 2, C] sums: the sums added in rank order from
    slot 0 (as ``parallel/collectives.py: sum_in_rank_order`` adds them),
    then :func:`bn_bwd_apply_plain` over the group's ``rows``."""
    total = sums[0].clone()
    for w in range(1, sums.shape[0]):
        total += sums[w]
    return bn_bwd_apply_plain(g2d, x2d, mean, inv, scale, offset, total, act,
                              rows)


def bn_bwd_apply_split(g2d: torch.Tensor, x2d: torch.Tensor,
                       mean: torch.Tensor, inv: torch.Tensor,
                       scale: torch.Tensor, offset: torch.Tensor,
                       sums: torch.Tensor, rows: int,
                       act: Optional[str] = None) -> torch.Tensor:
    """K2d in the split mode with the ranks' sums added in rank order
    folded in: dx = (gz - Σgz/N - xhat·Σ(gz·xhat)/N)·inv·scale in x's dtype
    from the ranks' gathered [W, 2, C] f32 sums, N = ``rows`` (the group's
    rows). Each block adds its tile's W sums from slot 0 on, the order
    every rank takes, so the ranks' sums are the same bits on every rank.
    One launch."""
    if x2d.device.type == "cpu":
        return bn_bwd_apply_split_plain(g2d, x2d, mean, inv, scale, offset,
                                        sums, rows, act)
    _check_2d(x2d, "bn_bwd_apply_split")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    r, c = x2d.shape
    if sums.dtype != torch.float32 or sums.ndim != 3 \
            or sums.shape[1:] != (2, c) or sums.device != x2d.device:
        raise ValueError(f"bn_bwd_apply_split takes the ranks' [W, 2, {c}] "
                         f"f32 sums on {x2d.device}, got {sums.dtype} "
                         f"{tuple(sums.shape)} on {sums.device}")
    if int(rows) < 1:
        raise ValueError(f"bn_bwd_apply_split: {rows} rows")
    g2d = _same_layout(g2d, x2d, "bn_bwd_apply_split")
    chan = _chan_f32(x2d, mean, inv, scale, offset)
    sums = sums.contiguous()
    dx = torch.empty_like(x2d)
    aligned = all(t.data_ptr() % 16 == 0 for t in (g2d, x2d, dx))
    p = bn_bwd_apply_split_plan(r, c, x2d.dtype, sums.shape[0], aligned)
    code = build.lib().ggan_bn_bwd_apply_split(
        g2d.data_ptr(), x2d.data_ptr(), *[t.data_ptr() for t in chan],
        sums.data_ptr(), dx.data_ptr(), build.DTYPE_CODES[_DTYPES[x2d.dtype]],
        r, c, sums.shape[0], p.vec, p.tx, p.rows, p.n_rr, p.smem,
        float(int(rows)), build.ACT_CODES[act], build.stream_ptr(x2d.device))
    build.check(code, "ggan_bn_bwd_apply_split")
    bn_bwd_apply_split.launches += 1
    return dx


def bn_bwd_group(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, scale: torch.Tensor,
                 offset: torch.Tensor, act: Optional[str], group
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, this rank's red) of a BN whose statistics ran over ``group``:
    :func:`bn_bwd_local` in the rank's slot, one ``all_reduce`` of the
    buffer, :func:`bn_bwd_apply_split` over the group's rows. The rank's
    own red, read back from its slot, is what its scale and offset
    gradients are (the step averages them over the group). One rank:
    K2c+K2d's one launch."""
    if group is None or group.size == 1:
        return bn_bwd(g2d, x2d, mean, inv, scale, offset, act)
    from graphical_gan_tpu_torch.parallel.collectives import (
        all_reduce_stack)
    sums = all_reduce_stack(bn_bwd_local(g2d, x2d, mean, inv, scale, offset,
                                         group.index, group.size, act),
                            group)
    dx = bn_bwd_apply_split(g2d, x2d, mean, inv, scale, offset, sums,
                            x2d.shape[0] * group.size, act)
    # the all_reduce adds +0 from the other slots, which turns a -0 sum
    # into +0: the only way the rank's red here can differ from the sums
    # its kernel wrote
    return dx, sums[group.index]


bn_stats.launches = 0
bn_apply.launches = 0
bn_apply_q8.launches = 0
bn_bwd.launches = 0
bn_stats_local.launches = 0
bn_apply_split.launches = 0
bn_apply_split_q8.launches = 0
bn_bwd_local.launches = 0
bn_bwd_apply_split.launches = 0


def bn_act_backward_plain(g: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor, offset: torch.Tensor,
                          act: Optional[str] = None, eps: float = EPS,
                          group=None):
    """(dx, dscale, doffset) of ``act(batchnorm(x))`` at cotangent g, from
    the statistics up, in plain differentiable PyTorch: what autograd
    differentiates for the second-order term, as JAX differentiates its
    ``jnp`` BN twice (``ops/norm.py:84-89``). act' is piecewise constant,
    so its mask carries no gradient. With ``group`` the statistics and the
    backward's sums run over the rows of every rank of the group (through
    the differentiable ``parallel/collectives.py: group_sum``); dscale and
    doffset are this rank's sums."""
    from graphical_gan_tpu_torch.parallel.collectives import group_sum
    c = x.shape[-1]
    x2d, g2d = x.reshape(-1, c).float(), g.reshape(-1, c).float()
    n = x2d.shape[0] * (1 if group is None else group.size)

    def mean_rows(t):
        if group is None or group.size == 1:
            return t.mean(dim=0)
        return group_sum(t.sum(dim=0), group) / n

    mean = mean_rows(x2d)
    d = x2d - mean
    inv = torch.rsqrt(mean_rows(d.square()) + eps)
    xhat = d * inv
    y = xhat * scale.float() + offset.float()
    gz = g2d * activation_grad(act, y.detach())
    dgx = mean_rows(gz * xhat)
    dx = (gz - mean_rows(gz) - xhat * dgx) * inv * scale.float()
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
    def forward(ctx, g, x, scale, offset, mean, inv, act, eps, group=None):
        c = x.shape[-1]
        x2d, g2d = x.reshape(-1, c), g.reshape(-1, c)
        dx, red = bn_bwd_group(g2d, x2d, mean, inv, scale, offset, act,
                               group)
        # under a group red is the rank's slot of the exchange buffer after
        # the all_reduce, which turns a -0 there into +0: on the CPU (the
        # plain sums) dscale and doffset can differ from the chain before
        # the exchange buffer only in the sign of a zero
        ctx.save_for_backward(g, x, scale, offset)
        ctx.conf = (act, eps, group)
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
        return (*out, None, None, None, None, None)


class FusedBatchNormAct(torch.autograd.Function):
    """act(batchnorm(x)) over channels-last x with batch statistics, with the
    JAX package's custom VJP (``fused_norm.py:174-236``).

    Forward: K2a then K2b (under a group of two or more ranks
    :func:`bn_stats_local`, the exchange, :func:`bn_apply_split`); saves
    ``(x, scale, offset, mean, inv)`` as ``_fwd`` does. Backward: K2c+K2d
    (:class:`_BatchNormActBackward`; under a group :func:`bn_bwd_local`,
    the exchange, :func:`bn_bwd_apply_split`);
    ``dx`` in x's dtype, ``dscale = Σgz·xhat`` and ``doffset = Σgz`` in f32,
    cast to the parameters' dtypes. The backward can be differentiated once
    more, as the mnist discriminator's gradient penalty needs: the
    second-order term is plain PyTorch."""

    @staticmethod
    def forward(ctx, x, scale, offset, act, eps, group=None):
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        if group is None or group.size == 1:
            mean, _, inv = bn_stats(x2d, eps)
            y = bn_apply(x2d, mean, inv, scale, offset, act)
        else:
            y, stats = bn_apply_split(x2d, bn_stats_exchange(x2d, group),
                                      scale, offset, act, eps)
            mean, inv = stats[0], stats[2]
        ctx.save_for_backward(x, scale, offset, mean, inv)
        ctx.conf = (act, eps, group)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, offset, mean, inv = ctx.saved_tensors
        dx, dscale, doffset = _BatchNormActBackward.apply(
            g, x, scale, offset, mean, inv, *ctx.conf)
        return dx, dscale, doffset, None, None, None


def fused_batchnorm_act(x: torch.Tensor, scale: torch.Tensor,
                        offset: torch.Tensor, act: Optional[str] = None,
                        eps: float = EPS, group=None) -> torch.Tensor:
    """act(batchnorm(x)) over channels-last x with batch statistics.

    x: [..., C] contiguous; scale/offset: [C]. Output in x's dtype. With
    ``group`` (``parallel/collectives.py: Group``) the statistics are those
    of the rows of every rank of the group: K2a and K2c+K2d run in their
    split modes, the cross-rank sums between their phases."""
    return FusedBatchNormAct.apply(x, scale, offset, act, eps, group)


def batchnorm_act_q8(x: torch.Tensor, scale: torch.Tensor,
                     offset: torch.Tensor, act: Optional[str], s_x: float,
                     eps: float = EPS, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """act(batchnorm(x)) over channels-last x with batch statistics, and
    its int8 copy at ``s_x``: K2a, then K2b with its second output. For the
    int8 serving path only (no gradient). With ``group`` the statistics
    are the whole batch's over its ranks, as a data-parallel server needs:
    :func:`bn_stats_exchange`, then :func:`bn_apply_split_q8`."""
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    if group is None or group.size == 1:
        mean, _, inv = bn_stats(x2d, eps)
        y, q = bn_apply_q8(x2d, mean, inv, scale, offset, act, s_x)
    else:
        y, q, _ = bn_apply_split_q8(x2d, bn_stats_exchange(x2d, group),
                                    scale, offset, act, s_x, eps)
    return y.reshape(x.shape), q.reshape(x.shape)
