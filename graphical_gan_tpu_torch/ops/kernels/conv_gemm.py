"""K3: ``conv_gemm``, a SAME k x k conv at stride s + bias (+ LeakyReLU).

Replaces ``graphical_gan_tpu/ops/pallas/conv_gemm.py:conv_gemm``, the
shape-specialised implicit GEMM of the discriminator stack, in both of its
variants: K3a :func:`conv_gemm_taps` (``variant="taps"``, the 25 taps'
products accumulate into one f32 tile) and K3b :func:`conv_gemm_im2col`
(``variant="im2col"``, one contraction over the flattened K·K·Cin axis).
The CUDA kernels are ``csrc/conv_gemm.cu``: bf16 on the tensor cores
(``mma.sync``), f32 on plain FMAs; see the source for the design and bound.
Its only caller outside the tests is ``tools/bench_conv_kernel.py``, as in
the JAX package.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it computes :func:`conv_gemm_plain`, the counterpart of the JAX
``conv_gemm_reference``. :func:`phase_stack` is the TPU kernel's input
layout in plain PyTorch, with a span per spatial axis, for the geometry
test; the CUDA kernels index the input directly and never build it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.kernels import build
from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
VARIANTS = ("taps", "im2col")


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


def _launch(wrapper, variant: int, x, w, bias, stride, leak):
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
    b, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    oh, ow = -(-h // stride), -(-wd // stride)
    pad_h, pad_w = same_pads(h, k, stride)[0], same_pads(wd, k, stride)[0]
    bias = bias.contiguous()
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if max(x.numel(), y.numel(), w.numel()) >= 2 ** 31:
        raise ValueError(f"{name} indexes rows with 32-bit ints; split the "
                         "batch")
    vec_a = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(cout % 8 == 0 and w.data_ptr() % 16 == 0)
    code = build.lib().ggan_conv_gemm(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x.dtype]], variant, b, h, wd, cin, k, cout,
        oh, ow, stride, pad_h, pad_w, int(leak is not None),
        float(leak or 0.0), vec_a, vec_w, build.stream_ptr(x.device))
    build.check(code, "ggan_conv_gemm")
    wrapper.launches += 1
    return y


def conv_gemm_taps(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   stride: int = 2, leak: Optional[float] = 0.2
                   ) -> torch.Tensor:
    """K3a: the K loop runs tap by tap, each a Cin-deep product."""
    return _launch(conv_gemm_taps, 0, x, w, bias, stride, leak)


def conv_gemm_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     stride: int = 2, leak: Optional[float] = 0.2
                     ) -> torch.Tensor:
    """K3b: the K loop runs over the flattened K·K·Cin axis."""
    return _launch(conv_gemm_im2col, 1, x, w, bias, stride, leak)


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
    where the whole batch always rides M and Cout is masked, not blocked."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if n_block < 1 or b_block < 1:
        raise ValueError("n_block and b_block must be positive")
    fn = conv_gemm_taps if variant == "taps" else conv_gemm_im2col
    return fn(x, w, bias, stride, leak)
