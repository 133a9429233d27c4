"""K1: ``act(conv2d(x, w, stride, padding) + bias)`` over NHWC/HWIO, padding
SAME, VALID or explicit per-axis ``(lo, hi)`` pads.

Replaces ``graphical_gan_tpu/ops/pallas/fused_conv.py:_forward_pallas``
(the Pallas implicit GEMM behind ``fused_conv2d_bias_act``). The CUDA
kernels are in ``csrc/fused_conv*.cu`` (the design is in
``fused_conv.cu``): an implicit GEMM over M = B*OH*OW
pixels x Cout that computes each input coordinate and masks the padding,
with no padded or phase-split copy in device memory. :func:`plan` picks,
from the shape alone, its mainloop (bf16 on ``wgmma`` tensor cores with
16-byte gathers, bf16 on ``mma.sync`` with element gathers where Cin or
Cout is not a multiple of 8, f32 on FMAs), its tile and, in bf16, how many
ways the K loop is split; the split partials are summed in a fixed order
by a second kernel, so a call is deterministic. See the source for the
design.

On a CUDA tensor :func:`fused_conv2d_bias_act` calls the op
``ggan::fused_conv2d_bias_act`` (a ``torch.library.custom_op``, so
``torch.export`` traces through it), which launches the plan's kernels or
raises; on a CPU tensor it computes :func:`fused_conv2d_bias_act_plain`
(whose aten ops CPU traces and FLOP counters see),
the same function in plain PyTorch (the CPU tests and ``chip_smoke.py``
compare against it). :func:`conv2d_bias_act` is the JAX
``fused_conv2d_bias_act`` with its custom VJP (:class:`FusedConv2dBiasAct`):
the forward is that kernel, the backward is PyTorch code on both devices,
as the JAX package leaves the conv gradients to XLA
(``fused_conv.py:183-190``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.activations import (
    LEAKY_ALPHA, activation, activation_grad)
from graphical_gan_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/XLA SAME padding: out = ceil(size/s); the odd pad goes high."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    lo = total // 2
    return lo, total - lo


def out_size(size: int, k: int, s: int, padding) -> int:
    """Output size of one axis under ``padding``: "SAME", "VALID" or that
    axis's explicit ``(lo, hi)``."""
    if padding == "SAME":
        return -(-size // s)
    if padding == "VALID":
        return (size - k) // s + 1
    if isinstance(padding, tuple):
        lo, hi = padding
        return (size + lo + hi - k) // s + 1
    raise ValueError(f"padding must be 'SAME', 'VALID' or ((lo, hi), "
                     f"(lo, hi)), got {padding!r}")


def explicit_pads(padding):
    """``padding`` as K1's wrappers take it: "SAME", "VALID", or per-axis
    ``((lo, hi), (lo, hi))`` of non-negative ints (rows, then columns), as
    tuples so that :func:`plan` can cache it."""
    if isinstance(padding, str):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or ((lo, "
                             f"hi), (lo, hi)), got {padding!r}")
        return padding
    pads = tuple(tuple(int(p) for p in axis) for axis in padding)
    if len(pads) != 2 or any(len(a) != 2 or min(a) < 0 for a in pads):
        raise ValueError(f"explicit padding must be ((lo, hi), (lo, hi)) "
                         f"of non-negative ints, got {padding!r}")
    return pads


def pad_spec(padding) -> Tuple[str, List[int]]:
    """:func:`explicit_pads`' form as an op's arguments: "SAME" or "VALID"
    with no pads, or "EXPLICIT" with ``[lo_h, hi_h, lo_w, hi_w]``."""
    if isinstance(padding, str):
        return padding, []
    return "EXPLICIT", [p for axis in padding for p in axis]


def pad_of(mode: str, pads: List[int]):
    """The padding :func:`pad_spec` encoded."""
    if mode != "EXPLICIT":
        return mode
    return (int(pads[0]), int(pads[1])), (int(pads[2]), int(pads[3]))


def _axes(padding):
    """The padding of each spatial axis (rows, columns)."""
    return (padding, padding) if isinstance(padding, str) else padding


def _pads(h: int, w: int, kh: int, kw: int, stride: int, padding):
    if padding == "SAME":
        return same_pads(h, kh, stride), same_pads(w, kw, stride)
    if padding == "VALID":
        return (0, 0), (0, 0)
    return padding


SMS = 132              # streaming multiprocessors of an H100 SXM: one wave
MIN_SPLIT_STEPS = 4    # K steps a split keeps at least
PATH_CODES = {"fma": 0, "mma": 1, "wgmma": 2}  # csrc/fused_conv.cu: Path


@dataclass(frozen=True)
class Plan:
    """How one K1 call runs: the mainloop (``path``), 16-byte gathers
    (``vec``), the tile ``bm`` x ``bn``, the K depth ``bk`` of one step,
    the ring's ``stages``, and the K loop cut into ``splits`` ranges of
    ``steps_per_split`` steps (the last may be shorter)."""
    path: str
    vec: bool
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    steps_per_split: int
    m: int
    n: int
    r: int

    @property
    def tiles(self) -> int:
        return -(-self.m // self.bm) * -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def k_ranges(self):
        """The reduction columns [lo, hi) of each split, in the order the
        partials are summed."""
        step = self.steps_per_split * self.bk
        return [(z * step, min(self.r, (z + 1) * step))
                for z in range(self.splits)]


# tiles (BM, BN), largest first (csrc/fused_conv_fma.cu: launch_fma_vec,
# fused_conv_wgmma.cu: launch_wgmma_tile); f32: 8 x 8, 4 x 4 and 2 x 4
# outputs per thread, 256 threads each
F32_TILES = ((128, 128), (64, 64), (32, 64))
WGMMA_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))


def fills_wave(blocks: int, waves: int = 1) -> bool:
    """Blocks on at least 9 in 10 of the card's SMs, ``waves`` deep
    (measured on the H100: 128 tiles of 64 x 64 beat 256 smaller ones or a
    split K)."""
    return 10 * blocks >= 9 * SMS * waves


# the waves a split K fills where its floor allows: once a shape pays for
# the reduce, 3 blocks of 64 x 64 per SM (as many as its shared memory
# holds) hide each other's gathers; tools/sweep_k1_plan.py on the H100
# found bf16 E.3 at B=64 19% faster at 6 splits than at the 2 that fill
# one wave
SPLIT_WAVES = 3


@functools.lru_cache(maxsize=None)
def plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...], stride: int,
         padding, dtype: torch.dtype) -> Plan:
    """K1's plan for x [B, H, W, Cin] and w [KH, KW, Cin, Cout] under
    ``padding`` (:func:`explicit_pads`' forms), a pure function of the
    shapes.

    - f32: ``fma`` (BK = 32, 3 stages; 16-byte gathers when Cin and Cout
      are multiples of 4), never on the tensor cores (no TF32) and never
      split: each output is one FMA chain over the reduction in HWIO order,
      the order of PyTorch's f32 CPU convolution at Cin >= 2, whose results
      the card's f32 results then equal bit for bit (the f32 card-against-
      CPU training checks lean on it; Cin = 1 takes another CPU algorithm).
    - bf16 with Cin and Cout multiples of 8: ``wgmma`` (BK = 64, 4 stages);
      other bf16 (Cin 1 or 3): ``mma`` with element gathers (BK = 32, 64 x
      64 tiles).
    - The tile is the largest (of those with BN = 64 when Cout <= 64) whose
      tiles fill a wave (:func:`fills_wave`), else the smallest. Where that
      is short of a wave in bf16, the K loop is split: the fewest splits of
      at least MIN_SPLIT_STEPS steps that fill SPLIT_WAVES waves, or as
      many as that floor allows; then balanced, so every split but the
      last has the same whole number of steps and none is empty.
    """
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    ph, pw = _axes(padding)
    m = b * out_size(h, kh, stride, ph) * out_size(wd, kw, stride, pw)
    r = kh * kw * cin
    if dtype == torch.float32:
        bm, bn = pick_tile(F32_TILES, m, cout)
        steps = max(1, -(-r // 32))
        return Plan("fma", cin % 4 == 0 and cout % 4 == 0, bm, bn, 32, 3, 1,
                    steps, m, cout, r)
    if dtype != torch.bfloat16:
        raise TypeError(f"K1 takes f32 or bf16, got {dtype}")
    if cin % 8 == 0 and cout % 8 == 0:
        path, vec, bk, stages = "wgmma", True, 64, 4
        bm, bn = pick_tile(WGMMA_TILES, m, cout)
    else:
        path, vec, bk, stages = "mma", False, 32, 2
        bm, bn = 64, 64
    steps = max(1, -(-r // bk))
    splits, per = split_steps(steps, n_tiles(m, cout, bm, bn))
    return Plan(path, vec, bm, bn, bk, stages, splits, per, m, cout, r)


def n_tiles(m: int, cout: int, bm: int, bn: int) -> int:
    return max(1, -(-m // bm) * -(-cout // bn))


def pick_tile(tiles, m: int, cout: int) -> Tuple[int, int]:
    """The largest tile (of those with BN = 64 when Cout <= 64) whose
    tiles fill a wave, else the smallest."""
    tiles = [t for t in tiles if cout > 64 or t[1] == 64]
    return next((t for t in tiles if fills_wave(n_tiles(m, cout, *t))),
                tiles[-1])


def split_steps(steps: int, tiles: int) -> Tuple[int, int]:
    """(splits, steps per split) of a bf16 K loop of ``steps`` steps over
    ``tiles`` tiles: unsplit where the tiles fill a wave or the loop is
    short; else the fewest splits of at least MIN_SPLIT_STEPS steps that
    fill SPLIT_WAVES waves, or as many as that floor allows; balanced, so
    every split but the last has the same whole number of steps and none is
    empty."""
    per = steps
    if not fills_wave(tiles) and steps >= 2 * MIN_SPLIT_STEPS:
        per = MIN_SPLIT_STEPS
        for cand in range(steps, MIN_SPLIT_STEPS - 1, -1):
            if fills_wave(-(-steps // cand) * tiles, SPLIT_WAVES):
                per = cand
                break
    splits = -(-steps // per)
    return splits, -(-steps // splits)


def fused_conv2d_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor, stride: int = 1,
                                padding="SAME",
                                act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: w and bias are cast to x's
    dtype (as the TPU kernel does), the products are summed in f32, bias and
    act are applied in f32 and the result is cast back to x's dtype."""
    padding = explicit_pads(padding)
    kh, kw = w.shape[:2]
    (plo, phi), (qlo, qhi) = _pads(x.shape[1], x.shape[2], kh, kw, stride,
                                   padding)
    x32 = x.float().permute(0, 3, 1, 2)
    w32 = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(F.pad(x32, (qlo, qhi, plo, phi)), w32, stride=stride)
    y = y + bias.to(x.dtype).float().view(1, -1, 1, 1)
    return activation(act)(y).permute(0, 2, 3, 1).contiguous().to(x.dtype)


def fused_conv2d_bias_act(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, stride: int = 1,
                          padding="SAME",
                          act: Optional[str] = None) -> torch.Tensor:
    """K1: act(conv2d(x, w, stride, padding) + bias): on CUDA the
    :func:`plan`'s mainloop kernel, and its split-K reduce where the plan
    splits K; one count in ``launches`` per call. On CUDA it runs as the
    op ``ggan::fused_conv2d_bias_act``.

    x: [B, H, W, Cin] contiguous NHWC; w: [KH, KW, Cin, Cout] (HWIO);
    bias: [Cout]; padding "SAME", "VALID" or per-axis ``((lo, hi), (lo,
    hi))``. f32 or bf16; f32 accumulation; output in x's dtype.
    """
    padding = explicit_pads(padding)
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3] \
            or bias.shape != (w.shape[3],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not form an NHWC/HWIO "
                         "conv")
    if x.device.type == "cpu":
        return fused_conv2d_bias_act_plain(x, w, bias, stride, padding, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_conv2d_bias_act: no kernel for {x.device}")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    mode, pads = pad_spec(padding)
    return build.run_op(_k1, _k1_cuda, x, w, bias, stride, mode, pads,
                        act or "")


@torch.library.custom_op("ggan::fused_conv2d_bias_act", mutates_args=(),
                         device_types="cpu")
def _k1(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int,
        padding: str, pads: List[int], act: str) -> torch.Tensor:
    """K1 on CPU tensors (a program exported on the card, run on the
    CPU): the plain version."""
    return fused_conv2d_bias_act_plain(x, w, bias, stride,
                                       pad_of(padding, pads), act or None)


@_k1.register_fake
def _k1_fake(x, w, bias, stride, padding, pads, act):
    ph, pw = _axes(pad_of(padding, pads))
    kh, kw, _, cout = w.shape
    return x.new_empty((x.shape[0], out_size(x.shape[1], kh, stride, ph),
                        out_size(x.shape[2], kw, stride, pw), cout))


@_k1.register_kernel("cuda")
def _k1_cuda(x, w, bias, stride, padding, pads, act):
    padding, act = pad_of(padding, pads), act or None
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv2d_bias_act takes f32 or bf16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_conv2d_bias_act needs a contiguous NHWC x")
    y = run_plan(x, w, bias, stride, padding, act,
                 plan(tuple(x.shape), tuple(w.shape), stride, padding,
                      x.dtype))
    fused_conv2d_bias_act.launches += 1
    return y


def run_plan(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             stride: int, padding, act: Optional[str], p: Plan,
             leak: float = LEAKY_ALPHA) -> torch.Tensor:
    """K1's kernels on CUDA tensors that the caller has checked, run as
    plan ``p`` says, with ``leak`` the slope of ``leaky_relu``; counts no
    launch: :func:`fused_conv2d_bias_act` and K3b's wrapper
    (``conv_gemm.py``) each count their own calls, and
    ``tools/sweep_k1_plan.py`` passes the other plans it times. The C entry
    rejects a plan it has no kernel for."""
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ph, pw = _axes(padding)
    oh = out_size(h, kh, stride, ph)
    ow = out_size(wd, kw, stride, pw)
    (plo, _), (qlo, _) = _pads(h, wd, kh, kw, stride, padding)
    w = w.to(device=x.device, dtype=x.dtype).contiguous()
    bias = bias.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError("fused_conv2d_bias_act indexes pixels with 32-bit "
                         "ints; split the batch")
    if p.vec:  # 16-byte copies need 16-byte aligned rows
        x = x if x.data_ptr() % 16 == 0 else x.clone()
        w = w if w.data_ptr() % 16 == 0 else w.clone()
    ws = (torch.empty((p.splits, p.m, cout), dtype=torch.float32,
                      device=x.device) if p.splits > 1 else None)
    code = build.lib().ggan_conv2d_bias_act(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x.dtype]], b, h, wd, cin, kh, kw, cout, oh,
        ow, stride, plo, qlo, build.ACT_CODES[act], float(leak),
        PATH_CODES[p.path], p.bm, p.bn, p.bk, p.stages, int(p.vec), p.splits,
        p.steps_per_split, build.stream_ptr(x.device))
    build.check(code, "ggan_conv2d_bias_act")
    return y


fused_conv2d_bias_act.launches = 0


def conv2d_bias_act_backward(g: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, y: torch.Tensor, stride: int,
                             padding, act: Optional[str],
                             needs=(True, True, True)):
    """(dx, dw, dbias) of ``act(conv2d(x, w) + bias) = y`` at cotangent g,
    as the JAX ``_bwd`` computes them: ``gz = g·act'(y)`` in f32, cast to
    x's dtype; ``dbias = Σgz`` in f32; dx and dw are the gradients of the
    same asymmetrically padded conv (w cast to x's dtype), dw cast to w's
    dtype. Entries whose ``needs`` flag is False are None and are not
    computed. ``padding`` takes :func:`explicit_pads`' forms. Plain
    differentiable PyTorch: the wali-gp penalty
    differentiates this function again; where dw is not asked for, x
    enters detached (dx is linear in g and does not read x), so a second
    differentiation does not reach the graph that made x."""
    kh, kw = w.shape[:2]
    (plo, phi), (qlo, qhi) = _pads(x.shape[1], x.shape[2], kh, kw, stride,
                                   explicit_pads(padding))
    gz = (g.float() * activation_grad(act, y.float())).to(x.dtype)
    gz_nchw = gz.permute(0, 3, 1, 2)
    dx = dw = dbias = None
    if needs[0] or needs[1]:
        # NHWC viewed as channels-last NCHW: no copy to change layout; dx
        # does not read x, so without dw the op is handed no graph to x
        xin = x if needs[1] else x.detach()
        xp = F.pad(xin.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            gz_nchw, xp, w.to(x.dtype).permute(3, 2, 0, 1), None,
            [stride, stride], [0, 0], [1, 1], False, [0, 0], 1,
            [bool(needs[0]), bool(needs[1]), False])
        if needs[0]:
            h, wd = x.shape[1], x.shape[2]
            dx = dxp[:, :, plo:plo + h, qlo:qlo + wd].permute(0, 2, 3, 1)
        if needs[1]:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
    if needs[2]:
        dbias = gz.float().sum(dim=(0, 1, 2))
    return dx, dw, dbias


_scope = threading.local()


@contextlib.contextmanager
def input_grads_only():
    """A scope in which K1's backward computes the input gradient only.

    A gradient penalty differentiates D with respect to its input and reads
    nothing else of that pass; autograd still marks the filters and biases
    as needing gradients there, since they require them. XLA drops those
    terms from the JAX step by dead-code elimination; here the penalty
    opens this scope around its ``torch.autograd.grad(..., create_graph=
    True)``. The mark is thread-local, so the scope also runs that
    backward pass on the calling thread (autograd otherwise runs a CUDA
    node's backward on a device thread of its own, where the mark is not
    set). Scopes nest, and a rematerialized loss that opens one inside an
    outer backward marks only its own inner pass."""
    prev = getattr(_scope, "input_only", False)
    _scope.input_only = True
    try:
        with torch.autograd.set_multithreading_enabled(False):
            yield
    finally:
        _scope.input_only = prev


class FusedConv2dBiasAct(torch.autograd.Function):
    """The JAX ``fused_conv2d_bias_act`` with its custom VJP
    (``fused_conv.py:166-193``): K1 forward, saving ``(x, w, y)``; the
    backward (:func:`conv2d_bias_act_backward`) stays differentiable and
    computes only the gradients autograd asks for, and inside
    :func:`input_grads_only` only the input gradient. It does not run the
    forward conv again."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, act):
        y = fused_conv2d_bias_act(x, w, bias, stride, padding, act)
        ctx.save_for_backward(x, w, y)
        ctx.conf = (stride, padding, act)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if getattr(_scope, "input_only", False):
            needs = (needs[0], False, False)
        dx, dw, dbias = conv2d_bias_act_backward(
            g, x, w, y, *ctx.conf, needs=needs)
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dx, dw, dbias, None, None, None


def conv2d_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    stride: int = 1, padding="SAME",
                    act: Optional[str] = None) -> torch.Tensor:
    """act(conv2d(x, w, stride, padding) + bias) with gradients.

    x: [B, H, W, Cin] contiguous NHWC; w: [KH, KW, Cin, Cout] (HWIO);
    bias: [Cout]; padding "SAME", "VALID" or per-axis ``((lo, hi), (lo,
    hi))``. f32 or bf16; f32 accumulation; output in x's dtype.
    """
    return FusedConv2dBiasAct.apply(x, w, bias, stride,
                                    explicit_pads(padding), act)
