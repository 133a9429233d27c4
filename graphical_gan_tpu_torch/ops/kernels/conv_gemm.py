"""K3: ``conv_gemm``, a SAME k x k conv at stride s + bias (+ LeakyReLU).

Replaces ``graphical_gan_tpu/ops/pallas/conv_gemm.py:conv_gemm``, the
shape-specialised implicit GEMM of the discriminator stack, in both of its
variants: K3a :func:`conv_gemm_taps` (``variant="taps"``, the K loop runs
tap by tap, each tap a run of one tap's channels) and K3b
:func:`conv_gemm_im2col` (``variant="im2col"``, one contraction over the
flattened K·K·Cin axis). On the card the two are two ways of producing the
A tile (:func:`route`, a pure function of the shapes):

- K3b runs K1's kernels (``fused_conv.py: plan`` and ``run_plan``,
  ``csrc/fused_conv*.cu``) with SAME padding and the slope ``leak``: K1's
  flattened HWIO walk *is* K3b's K loop. bf16 with Cin and Cout multiples
  of 8 takes the ``wgmma`` mainloop (16-byte ``cp.async`` gathers), other
  bf16 the ``mma`` one, f32 the ``fma`` one.
- K3a in bf16 with Cin and Cout multiples of 8 runs
  ``csrc/conv_gemm_tma.cu``: ``wgmma`` fed by the Tensor Memory
  Accelerator, an im2col tensor map over x whose loads take a tap as their
  im2col offsets (:func:`tma_geometry` gives both maps' parameters), on
  K1's tiles and K splits over k·k·ceil(Cin/64) steps. Other shapes run
  K1's kernels as K3b does: there the taps order (kh, kw, ci) is the
  flattened order, so the two variants are one function run in one order.

Each wrapper counts its own launches; K1's counter does not see them. Its
only caller outside the tests is ``tools/bench_conv_kernel.py``, as in the
JAX package.

On a CUDA tensor each wrapper launches its routed kernel or raises; on a
CPU tensor it computes :func:`conv_gemm_plain`, the counterpart of the JAX
``conv_gemm_reference``. :func:`phase_stack` is the TPU kernel's input
layout in plain PyTorch, with a span per spatial axis, for the geometry
tests; the CUDA kernels never build it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.kernels import build
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    WGMMA_TILES, Plan, n_tiles, pick_tile, plan, run_plan, same_pads,
    split_steps)

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
VARIANTS = ("taps", "im2col")

TMA_BK = 64        # channels per K3a step: 64 bf16, one 128-byte row
TMA_STAGES = 4
# the range of a 4-D im2col map's bounding-box corners (cuda.h,
# cuTensorMapEncodeIm2col), and of its traversal strides
IM2COL_CORNER = (-128, 127)
MAX_TRAVERSAL_STRIDE = 8


def conv_gemm_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    stride: int = 2, leak: Optional[float] = 0.2
                    ) -> torch.Tensor:
    """``F.conv2d`` in f32 on x and w as given, + bias in f32, LeakyReLU
    ``where(y >= 0, y, leak·y)`` when ``leak`` is set, one cast to x's
    dtype (``conv_gemm.py:229-238``). SAME pads per spatial axis."""
    k = w.shape[0]
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], w.shape[1], stride))
    xp = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1), stride=stride)
    y = y + bias.float().view(1, -1, 1, 1)
    if leak is not None:
        y = torch.where(y >= 0, y, leak * y)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def phase_stack(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """[B, H, W, C] -> [s·s, B, span_h, span_w, C]: SAME-pad, then split
    the padded image by pixel parity, so that tap (kh, kw) reads phase
    (kh % s, kw % s) at offset (kh // s, kw // s). Each axis has its own
    span, ``(k - 1) // s + ceil(size / s)`` (the JAX version takes the
    height's for both)."""
    _, h, w, _ = x.shape
    spans, pads = [], []
    for size in (h, w):
        lo, hi = same_pads(size, k, s)
        span = (k - 1) // s + -(-size // s)
        need = (span - 1) * s + s  # phase p takes rows p, p + s, ...
        spans.append(span)
        pads.append((lo, max(hi, need - size - lo)))
    (pt, pb), (pl, pr) = pads
    xpad = F.pad(x, (0, 0, pl, pr, pt, pb))
    slabs = [xpad[:, ph::s, pw::s, :][:, :spans[0], :spans[1], :]
             for ph in range(s) for pw in range(s)]
    return torch.stack(slabs)


@dataclass(frozen=True)
class TmaGeometry:
    """K3a's two tensor maps (``csrc/conv_gemm_tma.cu``), innermost
    dimension first.

    x: an im2col map over [B, H, W, Cin] bf16: ``x_dims`` (Cin, W, H, B),
    ``x_strides`` the byte strides of dims 1-3, the bounding box's
    ``lower`` and ``upper`` corners (W, H), ``channels`` per pixel and
    ``pixels`` per column (the tile's BM), ``elem_strides`` the traversal
    strides (1, s, s, 1). w: a tiled map over [k·k, Cin, Cout]:
    ``w_dims`` (Cout, Cin, k·k), ``w_strides`` in bytes, ``w_box``."""
    x_dims: Tuple[int, int, int, int]
    x_strides: Tuple[int, int, int]
    lower: Tuple[int, int]
    upper: Tuple[int, int]
    channels: int
    pixels: int
    elem_strides: Tuple[int, int, int, int]
    w_dims: Tuple[int, int, int]
    w_strides: Tuple[int, int]
    w_box: Tuple[int, int, int]
    k: int
    stride: int
    out_hw: Tuple[int, int]

    def packed(self) -> Tuple[int, ...]:
        """The 25 parameters in the order ``ggan_conv_gemm_tma`` reads."""
        return (*self.x_dims, *self.x_strides, *self.lower, *self.upper,
                self.channels, self.pixels, *self.elem_strides,
                *self.w_dims, *self.w_strides, *self.w_box)

    def a_load(self, m0: int, tap: int, c0: int):
        """The im2col load of the A tile of rows m0.. at K step (tap, c0):
        its coordinates (c0, w, h, n), the tile's first output pixel as its
        window's input coordinate (the lower corner is -pad), and its
        im2col offsets (kw, kh)."""
        oh, ow = self.out_hw
        t = m0 // ow
        coords = (c0, (m0 % ow) * self.stride + self.lower[0],
                  (t % oh) * self.stride + self.lower[1], t // oh)
        return coords, (tap % self.k, tap // self.k)


def tma_geometry(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                 stride: int, bm: int) -> TmaGeometry:
    """The maps of K3a's TMA path for x [B, H, W, Cin] and w [k, k, Cin,
    Cout] bf16 at stride s and tile rows ``bm``: per spatial axis the
    lower corner is -pad_lo and the upper pad_hi - (k - 1), so the box's
    traversal at stride s visits exactly the SAME windows' top-left
    corners. Raises where the 4-D map cannot express the shape."""
    b, h, wd, cin = x_shape
    k, _, _, cout = w_shape
    if cin % 8 or cout % 8:
        raise ValueError(f"K3a's TMA path needs Cin and Cout multiples of 8 "
                         f"(16-byte rows), got {cin}, {cout}")
    if not 1 <= stride <= MAX_TRAVERSAL_STRIDE:
        raise ValueError(f"K3a's im2col map takes strides 1-"
                         f"{MAX_TRAVERSAL_STRIDE}, got {stride}")
    (plo, phi), (qlo, qhi) = same_pads(h, k, stride), same_pads(wd, k, stride)
    lower, upper = (-qlo, -plo), (qhi - (k - 1), phi - (k - 1))
    lo, hi = IM2COL_CORNER
    if not all(lo <= c <= hi for c in lower + upper):
        raise ValueError(f"K3a's im2col corners {lower}, {upper} fall outside "
                         f"[{lo}, {hi}], the range of a 4-D map")
    return TmaGeometry(
        x_dims=(cin, wd, h, b), x_strides=(cin * 2, wd * cin * 2,
                                           h * wd * cin * 2),
        lower=lower, upper=upper, channels=TMA_BK, pixels=bm,
        elem_strides=(1, stride, stride, 1),
        w_dims=(cout, cin, k * k), w_strides=(cout * 2, cin * cout * 2),
        w_box=(64, TMA_BK, 1), k=k, stride=stride,
        out_hw=(-(-h // stride), -(-wd // stride)))


def k3a_steps(k: int, cin: int) -> List[Tuple[int, int]]:
    """K3a's K steps in order: (tap kh·k + kw, first channel c0), each
    tap's channels in blocks of 64, as the JAX ``_kernel`` runs its taps."""
    return [(t, c * TMA_BK) for t in range(k * k)
            for c in range(-(-cin // TMA_BK))]


@functools.lru_cache(maxsize=None)
def route(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...], stride: int,
          dtype: torch.dtype, variant: str) -> Plan:
    """How one K3 call runs on the card, a pure function of the shapes.

    K3a in bf16 with Cin and Cout multiples of 8: path ``tma``, K1's tile
    and split rules (``fused_conv.pick_tile``, ``split_steps``) over
    k·k·ceil(Cin/64) steps (``r`` counts those steps' 64 columns each).
    Everything else: K1's :func:`plan` with SAME padding (K3b always; K3a
    in f32 and where Cin or Cout is not a multiple of 8)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, h, wd, cin = x_shape
    k, _, _, cout = w_shape
    if variant == "taps" and dtype == torch.bfloat16 and cin % 8 == 0 \
            and cout % 8 == 0:
        m = b * -(-h // stride) * -(-wd // stride)
        bm, bn = pick_tile(WGMMA_TILES, m, cout)
        steps = len(k3a_steps(k, cin))
        splits, per = split_steps(steps, n_tiles(m, cout, bm, bn))
        return Plan("tma", True, bm, bn, TMA_BK, TMA_STAGES, splits, per, m,
                    cout, steps * TMA_BK)
    return plan(x_shape, w_shape, stride, "SAME", dtype)


def _run_tma(x, w, bias, stride, leak, p: Plan) -> torch.Tensor:
    """K3a's TMA mainloop (and K1's split-K reduce) as route ``p`` says."""
    b, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    geo = tma_geometry(tuple(x.shape), tuple(w.shape), stride, p.bm)
    oh, ow = geo.out_hw
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError("conv_gemm_taps indexes pixels with 32-bit ints; "
                         "split the batch")
    # tensor maps need 16-byte aligned bases
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    w = w if w.data_ptr() % 16 == 0 else w.clone()
    ws = (torch.empty((p.splits, p.m, cout), dtype=torch.float32,
                      device=x.device) if p.splits > 1 else None)
    packed = geo.packed()
    params = (ctypes.c_longlong * len(packed))(*packed)
    code = build.lib().ggan_conv_gemm_tma(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), ctypes.addressof(params), b, h,
        wd, cin, k, cout, oh, ow, stride, -geo.lower[1], -geo.lower[0],
        build.ACT_CODES[None if leak is None else "leaky_relu"],
        float(leak or 0.0), p.bm, p.bn, p.splits, p.steps_per_split,
        build.stream_ptr(x.device))
    build.check(code, "ggan_conv_gemm_tma")
    return y


def _launch(wrapper, variant: str, x, w, bias, stride, leak):
    name = wrapper.__name__
    if x.ndim != 4 or w.ndim != 4 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[3] or bias.shape != (w.shape[3],):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)} do not "
                         "form an NHWC/HWIO conv with a square filter")
    if x.device.type == "cpu":
        return conv_gemm_plain(x, w, bias, stride, leak)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {x.dtype}")
    if w.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"{name}: x, w and bias must share one dtype, got "
                        f"{x.dtype}, {w.dtype}, {bias.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous NHWC x and HWIO w")
    p = route(tuple(x.shape), tuple(w.shape), stride, x.dtype, variant)
    bias = bias.contiguous()
    if p.path == "tma":
        y = _run_tma(x, w, bias, stride, leak, p)
    else:
        y = run_plan(x, w, bias, stride, "SAME",
                     None if leak is None else "leaky_relu", p,
                     0.0 if leak is None else leak)
    wrapper.launches += 1
    return y


def conv_gemm_taps(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   stride: int = 2, leak: Optional[float] = 0.2
                   ) -> torch.Tensor:
    """K3a: the K loop runs tap by tap, each a Cin-deep product."""
    return _launch(conv_gemm_taps, "taps", x, w, bias, stride, leak)


def conv_gemm_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     stride: int = 2, leak: Optional[float] = 0.2
                     ) -> torch.Tensor:
    """K3b: the K loop runs over the flattened K·K·Cin axis."""
    return _launch(conv_gemm_im2col, "im2col", x, w, bias, stride, leak)


conv_gemm_taps.launches = 0
conv_gemm_im2col.launches = 0


def conv_gemm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              stride: int = 2, leak: Optional[float] = 0.2,
              n_block: int = 128, b_block: int = 64,
              variant: str = "taps") -> torch.Tensor:
    """SAME conv + bias (+ LeakyReLU when ``leak`` is set) over NHWC x and
    HWIO w, f32 accumulation, output in x's dtype; the JAX signature.

    ``n_block`` and ``b_block`` are the TPU kernel's VMEM tiling hints
    (Cout block, batch block); they are accepted and change nothing here,
    where :func:`route` tiles M and Cout from the shapes."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if n_block < 1 or b_block < 1:
        raise ValueError("n_block and b_block must be positive")
    fn = conv_gemm_taps if variant == "taps" else conv_gemm_im2col
    return fn(x, w, bias, stride, leak)
