"""Q1 and Q2: the int8 kernels of the serving path (``csrc/quant.cu``).

They are the port of no Pallas kernel: the JAX package computes their
function through XLA (``graphical_gan_tpu/ops/quant.py:103 _q8`` and the
int8 contractions of ``:117-170``), which PyTorch has no CUDA counterpart
for (see the source).

- Q1 :func:`quantize_int8`: ``clip(round_half_even(f32(x) / s), -127,
  127)`` as int8, one f32 scale for the tensor or one per channel of an
  axis (a weight's output channels);
- Q2 :func:`int8_conv`: int8 NHWC x conv int8 HWIO w, stride 1 or 2,
  explicit per-axis pads, int32 sums, written as the sums themselves
  (``out_dtype=torch.int32``) or as ``f32(acc) * factor[o]`` rounded to
  ``out_dtype`` (f32 or bf16), ``factor = f32(s_x) * s_w``. A linear layer
  is a 1x1 conv over ``[M, 1, 1, K]``.

Each wrapper checks its arguments. On a CUDA tensor it calls its op
(``ggan::quantize_int8``, ``ggan::int8_conv``: ``torch.library.custom_op``s,
so ``torch.export`` traces through them), which launches the kernel (one
count in the wrapper's ``launches``) or raises; on a CPU tensor it computes
the plain version:
Q1 the same formula in torch, Q2 ``F.conv2d`` in float64 on the int8
values (exact: every sum is below 2**53), rounded to int32, then the same
f32 epilogue.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.kernels import build
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    _pads, explicit_pads, out_size, pad_of, pad_spec)

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


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                    factor: Optional[torch.Tensor], stride: int = 1,
                    padding="VALID",
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    acc = int8_conv_sums_plain(xq, wq, stride, padding)
    if out_dtype == torch.int32:
        return acc
    return dequantize_plain(acc, factor, out_dtype)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor,
              factor: Optional[torch.Tensor], stride: int = 1,
              padding="VALID",
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Q2: int8 xq [B, H, W, Cin] (NHWC) conv int8 wq [KH, KW, Cin, Cout]
    (HWIO) with int32 sums; padding "SAME", "VALID" or per-axis ``((lo,
    hi), (lo, hi))``. ``out_dtype`` int32 returns the sums; f32 or bf16
    returns ``f32(acc) * factor`` (factor f32 [Cout]) rounded to it. On
    CUDA it runs as the op ``ggan::int8_conv``."""
    padding = explicit_pads(padding)
    if xq.ndim != 4 or wq.ndim != 4:
        raise ValueError(f"int8_conv takes NHWC x and HWIO w, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 x and w, got {xq.dtype} and "
                        f"{wq.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"int8_conv writes f32, bf16 or int32, got "
                        f"{out_dtype}")
    _geometry(xq.shape, wq.shape, stride, padding)
    cout = wq.shape[3]
    if out_dtype != torch.int32 and (factor is None
                                     or factor.shape != (cout,)):
        raise ValueError(f"int8_conv needs an f32 factor of shape "
                         f"({cout},)")
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, factor, stride, padding, out_dtype)
    if xq.device.type != "cuda":
        raise RuntimeError(f"int8_conv: no kernel for {xq.device}")
    mode, pads = pad_spec(padding)
    return build.run_op(_q2, _q2_cuda, xq, wq, factor, stride, mode, pads,
                        out_dtype)


@torch.library.custom_op("ggan::int8_conv", mutates_args=(),
                         device_types="cpu")
def _q2(xq: torch.Tensor, wq: torch.Tensor, factor: Optional[torch.Tensor],
        stride: int, padding: str, pads: List[int],
        out_dtype: torch.dtype) -> torch.Tensor:
    """Q2 on CPU tensors (a program exported on the card, run on the
    CPU): the plain version."""
    return int8_conv_plain(xq, wq, factor, stride, pad_of(padding, pads),
                           out_dtype)


@_q2.register_fake
def _q2_fake(xq, wq, factor, stride, padding, pads, out_dtype):
    oh, ow, _, _ = _geometry(xq.shape, wq.shape, stride,
                             pad_of(padding, pads))
    return xq.new_empty((xq.shape[0], oh, ow, wq.shape[3]), dtype=out_dtype)


@_q2.register_kernel("cuda")
def _q2_cuda(xq, wq, factor, stride, padding, pads, out_dtype):
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("int8_conv needs contiguous x and w")
    oh, ow, (plo, _), (qlo, _) = _geometry(xq.shape, wq.shape, stride,
                                           pad_of(padding, pads))
    b, h, w, cin = xq.shape
    kh, kw, _, cout = wq.shape
    y = torch.empty((b, oh, ow, cout), dtype=out_dtype, device=xq.device)
    if y.numel() == 0:
        return y
    f_ptr = None
    if out_dtype != torch.int32:
        factor = factor.to(device=xq.device, dtype=torch.float32
                           ).contiguous()
        f_ptr = factor.data_ptr()
    avec = int(cin % 16 == 0 and xq.data_ptr() % 16 == 0)
    wvec = int(cout % 16 == 0 and wq.data_ptr() % 16 == 0)
    code = build.lib().ggan_int8_conv(
        xq.data_ptr(), wq.data_ptr(), f_ptr, y.data_ptr(),
        _OUT_CODES[out_dtype], b, h, w, cin, kh, kw, cout, oh, ow, stride,
        plo, qlo, avec, wvec, build.stream_ptr(xq.device))
    build.check(code, "ggan_int8_conv")
    int8_conv.launches += 1
    return y


quantize_int8.launches = 0
int8_conv.launches = 0
