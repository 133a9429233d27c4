"""Q1 and Q2: the int8 kernels of the serving path (``csrc/quant.cu``,
``csrc/quant_tma.cu``).

They are the port of no Pallas kernel: the JAX package computes their
function through XLA (``graphical_gan_tpu/ops/quant.py:103 _q8`` and the
int8 contractions of ``:117-170``), which PyTorch has no CUDA counterpart
for (see the sources).

- Q1 :func:`quantize_int8`: ``clip(round_half_even(f32(x) / s), -127,
  127)`` as int8, one f32 scale for the tensor or one per channel of an
  axis (a weight's output channels);
- Q2 :func:`int8_conv_packed`: int8 NHWC x conv an int8 filter held
  K-major (:func:`pack_filter`: ``[rows, KH*KW*Cin]``, one row per output
  channel in HWIO order, zero rows up to the N tile), stride 1 or 2,
  explicit per-axis pads, int32 sums, written as the sums themselves
  (``out_dtype=torch.int32``) or as ``f32(acc) * factor[o]`` rounded to
  ``out_dtype`` (f32 or bf16), ``factor = f32(s_x) * s_w``, then, where
  asked, ``+ bias`` and the activation in that dtype (:func:`bias_act_plain`).
  A linear layer is a 1x1 conv over ``[M, 1, 1, K]``. :func:`int8_conv`
  takes an HWIO filter and packs it per call.

How Q2 runs on the card is :func:`q2_plan`'s choice, a pure function of
the shapes: route ``tma`` (``wgmma`` s8 on TMA loads, its tile, K depth,
ring and K splits) where Cin is a multiple of 32 and the operands are
16-byte aligned, route ``mma`` (the ``mma.sync`` kernel) elsewhere.

Each wrapper checks its arguments. On a CUDA tensor it calls its op
(``ggan::quantize_int8``, ``ggan::int8_conv``: ``torch.library.custom_op``s,
so ``torch.export`` traces through them), which launches the kernel (one
count in the wrapper's ``launches``; Q2 also counts per route in
``int8_conv.routes``) or raises; on a CPU tensor it computes the plain
version: Q1 the same formula in torch, Q2 ``F.conv2d`` in float64 on the
int8 values (exact: every sum is below 2**53), rounded to int32, then the
same f32 epilogue.
"""

from __future__ import annotations

import functools
from dataclasses import asdict, dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.activations import LEAKY_ALPHA, activation
from graphical_gan_tpu_torch.ops.kernels import build
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    SMS, _pads, explicit_pads, fills_wave, n_tiles, out_size, pad_of,
    pad_spec)

_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
QMAX = 127
# the int32 sums stay exact while K * 127**2 < 2**31
MAX_K = (2 ** 31 - 1) // (QMAX * QMAX)

Scale = Union[float, torch.Tensor]


def _scale_view(x: torch.Tensor, scale: Scale, axis: Optional[int]
                ) -> torch.Tensor:
    """The f32 divisor of ``x``: a 0-d tensor, or the per-channel vector
    shaped to broadcast along ``axis``."""
    if axis is None:
        return torch.tensor(float(scale), dtype=torch.float32,
                            device=x.device)
    shape = [1] * x.ndim
    shape[axis] = -1
    return scale.to(device=x.device, dtype=torch.float32).reshape(shape)


def quantize_int8_plain(x: torch.Tensor, scale: Scale,
                        axis: Optional[int] = None) -> torch.Tensor:
    """``clip(round(f32(x) / s), -127, 127)`` as int8 (``_q8``)."""
    q = torch.round(x.float() / _scale_view(x, scale, axis))
    return q.clamp(-QMAX, QMAX).to(torch.int8)


def quantize_int8(x: torch.Tensor, scale: Scale,
                  axis: Optional[int] = None) -> torch.Tensor:
    """Q1: x (f32 or bf16) to int8 at ``scale``: a float for the whole
    tensor (its f32 rounding divides), or with ``axis`` an f32 vector of
    one scale per index of that axis. On CUDA it runs as the op
    ``ggan::quantize_int8``."""
    if axis is not None:
        axis = axis % x.ndim
        if scale.shape != (x.shape[axis],):
            raise ValueError(f"quantize_int8: {tuple(scale.shape)} scales "
                             f"for axis {axis} of {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x, scale, axis)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_int8: no kernel for {x.device}")
    if axis is not None:
        return build.run_op(_q1, _q1_cuda, x, 0.0, scale, axis)
    return build.run_op(_q1, _q1_cuda, x, float(scale), None, -1)


@torch.library.custom_op("ggan::quantize_int8", mutates_args=(),
                         device_types="cpu")
def _q1(x: torch.Tensor, scalar: float, scales: Optional[torch.Tensor],
        axis: int) -> torch.Tensor:
    """Q1 on a CPU tensor (a program exported on the card, run on the
    CPU): the plain version."""
    return quantize_int8_plain(x, scalar if axis < 0 else scales,
                               None if axis < 0 else axis)


@_q1.register_fake
def _q1_fake(x, scalar, scales, axis):
    return torch.empty_like(x, dtype=torch.int8)


@_q1.register_kernel("cuda")
def _q1_cuda(x, scalar, scales, axis):
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quantize_int8 takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 needs a contiguous tensor")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    n = x.numel()
    if n == 0:
        return q
    if axis < 0:
        s_ptr, c, inner = None, 1, 1
        vec = 4 if (n % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
                    and q.data_ptr() % 4 == 0) else 1
    else:
        s = scales.to(device=x.device, dtype=torch.float32).contiguous()
        s_ptr, c = s.data_ptr(), x.shape[axis]
        inner = 1
        for d in x.shape[axis + 1:]:
            inner *= d
        vec = 1
    code = build.lib().ggan_quantize_int8(
        x.data_ptr(), s_ptr, scalar, c, inner, q.data_ptr(),
        _IN_DTYPES[x.dtype], n, vec, build.stream_ptr(x.device))
    build.check(code, "ggan_quantize_int8")
    quantize_int8.launches += 1
    return q


def _geometry(x_shape, w_shape, stride: int, padding
              ) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
    """(OH, OW, row pads, column pads) of x [B, H, W, Cin] under an HWIO
    filter shape [KH, KW, Cin, Cout]; raises where Q2 cannot run it."""
    b, h, w, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if wcin != cin:
        raise ValueError(f"int8_conv: x {tuple(x_shape)} and w "
                         f"{tuple(w_shape)} do not form an NHWC/HWIO conv")
    if stride not in (1, 2):
        raise ValueError(f"int8_conv takes stride 1 or 2, got {stride}")
    if kh * kw * cin > MAX_K:
        raise ValueError(
            f"int8_conv: K = {kh}*{kw}*{cin} = {kh * kw * cin} products "
            f"of up to 127*127 would overflow the int32 sums (K must be at "
            f"most {MAX_K})")
    (plo, phi), (qlo, qhi) = _pads(h, w, kh, kw, stride, padding)
    oh = out_size(h, kh, stride, (plo, phi))
    ow = out_size(w, kw, stride, (qlo, qhi))
    return oh, ow, (plo, phi), (qlo, qhi)


# ---------------------------------------------------------------------------
# the K-major filter

Q2_BN = (16, 32, 64, 128)  # N tiles of the tma route (csrc/quant_tma.cu)


def n_tile(cout: int) -> int:
    """The widest N tile :func:`q2_plan` takes for ``cout`` channels: the
    smallest of :data:`Q2_BN` that holds them, else 128."""
    return next((bn for bn in Q2_BN if cout <= bn), Q2_BN[-1])


def filter_rows(cout: int) -> int:
    """Rows of the K-major filter: ``cout`` rounded up to its N tile."""
    bn = n_tile(cout)
    return -(-cout // bn) * bn


class PackedFilter(NamedTuple):
    """An int8 filter K-major, as both Q2 routes read it: ``wk[n, r]`` is
    the HWIO filter's ``w[kh, kw, ci, n]`` at ``r = (kh*KW + kw)*Cin +
    ci``, rows ``cout..`` zero up to :func:`filter_rows`."""
    wk: torch.Tensor
    kh: int
    kw: int
    cin: int
    cout: int

    @property
    def hwio_shape(self) -> Tuple[int, int, int, int]:
        return self.kh, self.kw, self.cin, self.cout


def pack_filter(wq: torch.Tensor) -> PackedFilter:
    """The K-major :class:`PackedFilter` of an int8 HWIO filter (made once
    per filter: ``ops/quant.py`` keeps it in the weight cache)."""
    kh, kw, cin, cout = wq.shape
    r = kh * kw * cin
    wk = wq.new_zeros((filter_rows(cout), r))
    wk[:cout] = wq.reshape(r, cout).t()
    return PackedFilter(wk, kh, kw, cin, cout)


def unpack_filter(pf: PackedFilter) -> torch.Tensor:
    """The HWIO filter back from its K-major rows."""
    return pf.wk[:pf.cout].t().reshape(pf.hwio_shape).contiguous()


# ---------------------------------------------------------------------------
# the plan

MMA_TILE = (64, 64, 32)    # csrc/quant.cu: QBM, QBN, QBK
TMA_BK = (128, 64, 32)     # K bytes a step: the swizzle of one smem row
MAX_STAGES = 4             # csrc/quant_tma.cu: MAX_STAGES
# ring bytes that leave an SM room for a second block (of its 227 KB)
RING_BYTES = 110 * 1024
# a split K's int32 workspace stays under this: beyond it, zeroing it and
# the atomics cost more than the blocks the split adds
# (tools/sweep_q2_plan.py on the H100: G.3 at B 8, 512 KB, took 0.0149 ms
# in 3 splits and 0.0131 unsplit; G.2, 256 KB, 0.0150 in 6)
SPLIT_WS_BYTES = 512 * 1024
# a 4-D im2col map's bounding-box corners (cuda.h, cuTensorMapEncodeIm2col)
IM2COL_CORNER = (-128, 127)


@dataclass(frozen=True)
class Q2Plan:
    """How one Q2 call runs: the kernel (``route``), the output tile ``bm``
    x ``bn``, the K bytes ``bk`` of one step (one tap's run of channels),
    the ring's ``stages``, the K loop cut into ``splits`` ranges of
    ``per`` steps (the last may be shorter), and whether x is a dense
    layer's ``[M, K]`` (a tiled map, not im2col)."""
    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    per: int
    dense: bool
    m: int
    n: int
    steps: int

    @property
    def tiles(self) -> int:
        return n_tiles(self.m, self.n, self.bm, self.bn)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def step_ranges(self) -> List[Tuple[int, int]]:
        """The K steps [lo, hi) of each split."""
        return [(z * self.per, min(self.steps, (z + 1) * self.per))
                for z in range(self.splits)]

    def as_dict(self) -> dict:
        return asdict(self)


def _im2col_ok(kh: int, kw: int, pads) -> bool:
    (plo, phi), (qlo, qhi) = pads
    lo, hi = IM2COL_CORNER
    corners = (-qlo, -plo, qhi - (kw - 1), phi - (kh - 1))
    return all(lo <= c <= hi for c in corners)


@functools.lru_cache(maxsize=None)
def q2_plan(x_shape: Tuple[int, ...], kh: int, kw: int, cout: int,
            stride: int, pads, aligned: bool = True,
            route: Optional[str] = None) -> Q2Plan:
    """How Q2 runs x [B, H, W, Cin] against a KH x KW filter to ``cout``
    channels at ``stride`` with explicit ``pads`` ``((lo, hi), (lo, hi))``,
    a pure function of the shapes (``aligned``: x and the filter start on
    16 bytes).

    Route ``tma`` where Cin % 32 == 0, the operands are aligned and the
    window fits a 4-D im2col map: K steps of bk = 128, 64 or 32 bytes (the
    largest dividing Cin: a step never crosses a tap); the largest tile
    (BN 128 or 64 where Cout > 64, else the N tile of ``cout``) whose tiles
    fill two waves (two blocks an SM run at once), else the smallest;
    where they fill under one wave and the int32 workspace stays under
    :data:`SPLIT_WS_BYTES`, K splits up to one wave of blocks; a ring of
    up to 4 stages within :data:`RING_BYTES`. Route ``mma`` elsewhere (or
    where ``route`` asks for it): the ``mma.sync`` kernel's 64 x 64 tiles,
    32-byte steps, double-buffered, unsplit."""
    b, h, w, cin = x_shape
    oh = out_size(h, kh, stride, pads[0])
    ow = out_size(w, kw, stride, pads[1])
    m, r = b * oh * ow, kh * kw * cin
    dense = (kh, kw, h, w, stride) == (1, 1, 1, 1, 1) and pads == (
        (0, 0), (0, 0))
    tma_ok = (aligned and cin % 32 == 0
              and (dense or _im2col_ok(kh, kw, pads)))
    if route not in (None, "mma"):
        raise ValueError(f"q2_plan forces only the 'mma' route, got "
                         f"{route!r}")
    if route == "mma" or not tma_ok:
        bm, bn, bk = MMA_TILE
        steps = -(-r // bk)
        return Q2Plan("mma", bm, bn, bk, 2, 1, steps, dense, m, cout, steps)
    bk = next(k for k in TMA_BK if cin % k == 0)
    steps = kh * kw * cin // bk
    bns = (128, 64) if cout > 64 else (n_tile(cout),)
    tiles_by_area = [(bm, bn) for bm in (128, 64) for bn in bns]
    tiles_by_area.sort(key=lambda t: -t[0] * t[1])
    bm, bn = next((t for t in tiles_by_area
                   if fills_wave(n_tiles(m, cout, *t), 2)),
                  tiles_by_area[-1])
    tiles = n_tiles(m, cout, bm, bn)
    splits = 1
    if not fills_wave(tiles) and 4 * m * cout < SPLIT_WS_BYTES:
        splits = max(1, min(steps, SMS // tiles))
    per = -(-steps // splits)
    splits = -(-steps // per)
    stages = max(1, min(MAX_STAGES, per, RING_BYTES // ((bm + bn) * bk)))
    return Q2Plan("tma", bm, bn, bk, stages, splits, per, dense, m, cout,
                  steps)


def split_sums_plain(xq: torch.Tensor, pf: PackedFilter, stride: int,
                     padding, plan: Q2Plan) -> List[torch.Tensor]:
    """The int32 sums of each of ``plan``'s K splits (each its steps' taps
    and channel blocks, in HWIO order): their sum is the whole product, as
    the kernel's atomics add them."""
    padding = explicit_pads(padding)
    wq = unpack_filter(pf)
    cpt = pf.cin // plan.bk if plan.route == "tma" else None
    out = []
    for lo, hi in plan.step_ranges():
        if cpt is None:  # mma: steps of bk columns of R
            cols = torch.arange(lo * plan.bk, min(hi * plan.bk,
                                                  pf.kh * pf.kw * pf.cin))
        else:            # tma: step s is tap s // cpt, block s % cpt
            cols = torch.cat([torch.arange(
                (s // cpt) * pf.cin + (s % cpt) * plan.bk,
                (s // cpt) * pf.cin + (s % cpt + 1) * plan.bk)
                for s in range(lo, hi)])
        keep = torch.zeros(pf.kh * pf.kw * pf.cin, dtype=torch.bool)
        keep[cols] = True
        part = wq * keep.view(pf.kh, pf.kw, pf.cin, 1).to(wq.dtype)
        out.append(int8_conv_sums_plain(xq, part, stride, padding))
    return out


# ---------------------------------------------------------------------------
# Q2

def int8_conv_sums_plain(xq: torch.Tensor, wq: torch.Tensor,
                         stride: int = 1, padding="VALID") -> torch.Tensor:
    """The int32 sums of int8 x [B, H, W, Cin] conv int8 w [KH, KW, Cin,
    Cout]: ``F.conv2d`` in float64, exact, rounded to int32."""
    padding = explicit_pads(padding)
    _, _, (plo, phi), (qlo, qhi) = _geometry(xq.shape, wq.shape, stride,
                                             padding)
    x64 = F.pad(xq.double().permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
    acc = F.conv2d(x64, wq.double().permute(3, 2, 0, 1), stride=stride)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def dequantize_plain(acc: torch.Tensor, factor: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``(f32(acc) * factor).to(out_dtype)``, the epilogue of Q2."""
    return (acc.float() * factor.to(acc.device, torch.float32)
            ).to(out_dtype)


def bias_act_plain(y: torch.Tensor, bias: Optional[torch.Tensor],
                   act: Optional[str]) -> torch.Tensor:
    """``act(y + bias)`` in y's dtype after an int8 product, as JAX's
    ``ops/conv.py:114-126`` applies them: the leaky slope is a weak-typed
    Python float there, so it is rounded to y's dtype before the product
    (0.2001953125 in bf16)."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act == "leaky_relu":
        return torch.maximum(
            y * torch.tensor(LEAKY_ALPHA, dtype=y.dtype, device=y.device), y)
    return activation(act)(y)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                    factor: Optional[torch.Tensor], stride: int = 1,
                    padding="VALID",
                    out_dtype: torch.dtype = torch.float32,
                    bias: Optional[torch.Tensor] = None,
                    act: Optional[str] = None) -> torch.Tensor:
    acc = int8_conv_sums_plain(xq, wq, stride, padding)
    if out_dtype == torch.int32:
        return acc
    return bias_act_plain(dequantize_plain(acc, factor, out_dtype), bias,
                          act)


def _check_q2(xq, hwio_shape, factor, stride, padding, out_dtype, bias,
              act) -> None:
    if xq.ndim != 4:
        raise ValueError(f"int8_conv takes NHWC x, got {tuple(xq.shape)}")
    if xq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 x and w, got {xq.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_conv writes f32, bf16 or int32, got "
                        f"{out_dtype}")
    _geometry(xq.shape, hwio_shape, stride, padding)
    cout = hwio_shape[3]
    if out_dtype != torch.int32 and (factor is None
                                     or factor.shape != (cout,)):
        raise ValueError(f"int8_conv needs an f32 factor of shape "
                         f"({cout},)")
    if act not in build.ACT_CODES:
        raise ValueError(f"int8_conv: unknown activation {act!r}")
    if out_dtype == torch.int32 and (bias is not None or act is not None):
        raise ValueError("int8_conv: the int32 sums take no bias or "
                         "activation")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"int8_conv needs a bias of shape ({cout},)")


def int8_conv_packed(xq: torch.Tensor, pf: PackedFilter,
                     factor: Optional[torch.Tensor], stride: int = 1,
                     padding="VALID",
                     out_dtype: torch.dtype = torch.float32,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """Q2: int8 xq [B, H, W, Cin] (NHWC) conv the K-major filter ``pf``
    with int32 sums; padding "SAME", "VALID" or per-axis ``((lo, hi), (lo,
    hi))``. ``out_dtype`` int32 returns the sums; f32 or bf16 returns
    ``f32(acc) * factor`` (factor f32 [Cout]) rounded to it, then ``+
    bias`` and ``act`` (None, "relu", "leaky_relu") in it where given. On
    CUDA it runs as the op ``ggan::int8_conv`` on :func:`q2_plan`'s
    route."""
    padding = explicit_pads(padding)
    if pf.wk.dtype != torch.int8 or pf.wk.shape != (
            filter_rows(pf.cout), pf.kh * pf.kw * pf.cin):
        raise ValueError(f"int8_conv: a packed filter of {pf.hwio_shape} "
                         f"is int8 [{filter_rows(pf.cout)}, "
                         f"{pf.kh * pf.kw * pf.cin}], got {pf.wk.dtype} "
                         f"{tuple(pf.wk.shape)}")
    _check_q2(xq, (pf.kh, pf.kw, xq.shape[-1], pf.cout), factor, stride,
              padding, out_dtype, bias, act)
    if pf.cin != xq.shape[-1]:
        raise ValueError(f"int8_conv: x {tuple(xq.shape)} and a filter of "
                         f"{pf.hwio_shape} do not form an NHWC/HWIO conv")
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, unpack_filter(pf), factor, stride,
                               padding, out_dtype, bias, act)
    if xq.device.type != "cuda":
        raise RuntimeError(f"int8_conv: no kernel for {xq.device}")
    mode, pads = pad_spec(padding)
    return build.run_op(_q2, _q2_cuda, xq, pf.wk, factor, bias, pf.kh, pf.kw,
                        pf.cout, stride, mode, pads, out_dtype, act or "")


def int8_conv(xq: torch.Tensor, wq: torch.Tensor,
              factor: Optional[torch.Tensor], stride: int = 1,
              padding="VALID",
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Q2 on an int8 HWIO filter wq [KH, KW, Cin, Cout]: packed K-major
    (:func:`pack_filter`) for this call, then :func:`int8_conv_packed`; on
    a CPU tensor the plain version on wq as it is."""
    padding = explicit_pads(padding)
    if wq.ndim != 4 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 x and w (HWIO), got "
                        f"{wq.dtype} {tuple(wq.shape)}")
    _check_q2(xq, tuple(wq.shape), factor, stride, padding, out_dtype, None,
              None)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, factor, stride, padding, out_dtype)
    return int8_conv_packed(xq, pack_filter(wq.contiguous()), factor,
                            stride, padding, out_dtype)


@torch.library.custom_op("ggan::int8_conv", mutates_args=(),
                         device_types="cpu")
def _q2(xq: torch.Tensor, wk: torch.Tensor, factor: Optional[torch.Tensor],
        bias: Optional[torch.Tensor], kh: int, kw: int, cout: int,
        stride: int, padding: str, pads: List[int], out_dtype: torch.dtype,
        act: str) -> torch.Tensor:
    """Q2 on CPU tensors (a program exported on the card, run on the
    CPU): the plain version."""
    pf = PackedFilter(wk, kh, kw, xq.shape[-1], cout)
    return int8_conv_plain(xq, unpack_filter(pf), factor, stride,
                           pad_of(padding, pads), out_dtype, bias,
                           act or None)


@_q2.register_fake
def _q2_fake(xq, wk, factor, bias, kh, kw, cout, stride, padding, pads,
             out_dtype, act):
    oh, ow, _, _ = _geometry(xq.shape, (kh, kw, xq.shape[-1], cout), stride,
                             pad_of(padding, pads))
    return xq.new_empty((xq.shape[0], oh, ow, cout), dtype=out_dtype)


@_q2.register_kernel("cuda")
def _q2_cuda(xq, wk, factor, bias, kh, kw, cout, stride, padding, pads,
             out_dtype, act):
    if not (xq.is_contiguous() and wk.is_contiguous()):
        raise ValueError("int8_conv needs contiguous x and w")
    padding = pad_of(padding, pads)
    b, h, w, cin = xq.shape
    oh, ow, (plo, phi), (qlo, qhi) = _geometry(
        xq.shape, (kh, kw, cin, cout), stride, padding)
    y = torch.empty((b, oh, ow, cout), dtype=out_dtype, device=xq.device)
    if y.numel() == 0:
        return y
    if y.numel() >= 2 ** 31:
        raise ValueError("int8_conv indexes outputs with 32-bit ints")
    aligned = xq.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
    p = q2_plan(tuple(xq.shape), kh, kw, cout, stride,
                ((plo, phi), (qlo, qhi)), aligned)
    return run_plan(xq, wk, factor, bias, kh, kw, cout, stride,
                    ((plo, phi), (qlo, qhi)), out_dtype, act or None, p, y)


def run_plan(xq: torch.Tensor, wk: torch.Tensor,
             factor: Optional[torch.Tensor], bias: Optional[torch.Tensor],
             kh: int, kw: int, cout: int, stride: int, pads,
             out_dtype: torch.dtype, act: Optional[str], p: Q2Plan,
             y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Q2 launch on CUDA tensors under the plan ``p`` (``q2_plan``'s;
    ``chip_smoke.py`` and ``tools/sweep_q2_plan.py`` also time the ``mma``
    route and other plans); the arguments as the op ``ggan::int8_conv``
    takes them, checked there, pads explicit."""
    (plo, phi), (qlo, qhi) = pads
    b, h, w, cin = xq.shape
    oh, ow = out_size(h, kh, stride, (plo, phi)), out_size(w, kw, stride,
                                                            (qlo, qhi))
    if y is None:
        y = torch.empty((b, oh, ow, cout), dtype=out_dtype, device=xq.device)
    f_ptr = b_ptr = None
    if out_dtype != torch.int32:
        factor = factor.to(device=xq.device, dtype=torch.float32
                           ).contiguous()
        f_ptr = factor.data_ptr()
    if bias is not None:
        bias = bias.to(device=xq.device, dtype=out_dtype).contiguous()
        b_ptr = bias.data_ptr()
    leak = (torch.tensor(LEAKY_ALPHA, dtype=out_dtype).item()
            if act == "leaky_relu" else 0.0)
    stream = build.stream_ptr(xq.device)
    common = (_OUT_CODES[out_dtype], build.ACT_CODES[act], leak,
              b, h, w, cin, kh, kw, cout, wk.shape[0], oh, ow, stride)
    aligned = xq.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
    if p.route == "mma":
        code = build.lib().ggan_int8_conv(
            xq.data_ptr(), wk.data_ptr(), f_ptr, b_ptr, y.data_ptr(),
            *common, plo, qlo, int(cin % 16 == 0 and aligned),
            int((kh * kw * cin) % 16 == 0 and aligned), stream)
        build.check(code, "ggan_int8_conv")
    else:
        # the split K's int32 sums and one counter per output tile, zero
        ws = (torch.zeros(p.m * cout + p.tiles, dtype=torch.int32,
                          device=xq.device) if p.splits > 1 else None)
        code = build.lib().ggan_int8_conv_tma(
            xq.data_ptr(), wk.data_ptr(), f_ptr, b_ptr, y.data_ptr(),
            None if ws is None else ws.data_ptr(), *common, plo, phi, qlo,
            qhi, int(p.dense), p.bm, p.bn, p.bk, p.stages, p.splits, p.per,
            stream)
        build.check(code, "ggan_int8_conv_tma")
    int8_conv.launches += 1
    int8_conv.routes[p.route] += 1
    return y


quantize_int8.launches = 0
int8_conv.launches = 0
int8_conv.routes = {"tma": 0, "mma": 0}
