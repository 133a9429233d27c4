"""K1: ``act(conv2d(x, w, stride, SAME|VALID) + bias)`` over NHWC/HWIO.

Replaces ``graphical_gan_tpu/ops/pallas/fused_conv.py:_forward_pallas``
(the Pallas implicit GEMM behind ``fused_conv2d_bias_act``). The CUDA kernel
is ``csrc/fused_conv.cu``: a direct implicit GEMM over M = B*OH*OW pixels x
Cout that computes each input coordinate and masks the padding, with no
padded or phase-split copy in device memory; it is bound by the operations
(plain f32 FMAs) at the serving shapes. See the source for the design.

On a CUDA tensor :func:`fused_conv2d_bias_act` launches the kernel or
raises; on a CPU tensor it computes :func:`fused_conv2d_bias_act_plain`, the
same function in plain PyTorch (the CPU tests and ``chip_smoke.py`` compare
against it). :func:`conv2d_bias_act` is the JAX ``fused_conv2d_bias_act``
with its custom VJP (:class:`FusedConv2dBiasAct`): the forward is that
kernel, the backward is PyTorch code on both devices, as the JAX package
leaves the conv gradients to XLA (``fused_conv.py:183-190``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops.activations import (
    activation, activation_grad)
from graphical_gan_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/XLA SAME padding: out = ceil(size/s); the odd pad goes high."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    lo = total // 2
    return lo, total - lo


def out_size(size: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // s)
    if padding == "VALID":
        return (size - k) // s + 1
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _pads(h: int, w: int, kh: int, kw: int, stride: int, padding: str):
    if padding == "SAME":
        return same_pads(h, kh, stride), same_pads(w, kw, stride)
    return (0, 0), (0, 0)


def fused_conv2d_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor, stride: int = 1,
                                padding: str = "SAME",
                                act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: w and bias are cast to x's
    dtype (as the TPU kernel does), the products are summed in f32, bias and
    act are applied in f32 and the result is cast back to x's dtype."""
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
                          padding: str = "SAME",
                          act: Optional[str] = None) -> torch.Tensor:
    """K1: act(conv2d(x, w, stride, padding) + bias), one kernel launch on
    CUDA.

    x: [B, H, W, Cin] contiguous NHWC; w: [KH, KW, Cin, Cout] (HWIO);
    bias: [Cout]. f32 or bf16; f32 accumulation; output in x's dtype.
    """
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3] \
            or bias.shape != (w.shape[3],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not form an NHWC/HWIO "
                         "conv")
    if x.device.type == "cpu":
        return fused_conv2d_bias_act_plain(x, w, bias, stride, padding, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_conv2d_bias_act: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv2d_bias_act takes f32 or bf16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_conv2d_bias_act needs a contiguous NHWC x")
    if act not in build.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh = out_size(h, kh, stride, padding)
    ow = out_size(wd, kw, stride, padding)
    (plo, _), (qlo, _) = _pads(h, wd, kh, kw, stride, padding)
    w = w.to(device=x.device, dtype=x.dtype).contiguous()
    bias = bias.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError("fused_conv2d_bias_act indexes pixels with 32-bit "
                         "ints; split the batch")
    code = build.lib().ggan_conv2d_bias_act(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        build.DTYPE_CODES[_DTYPES[x.dtype]], b, h, wd, cin, kh, kw, cout, oh,
        ow, stride, plo, qlo, build.ACT_CODES[act],
        build.stream_ptr(x.device))
    build.check(code, "ggan_conv2d_bias_act")
    fused_conv2d_bias_act.launches += 1
    return y


fused_conv2d_bias_act.launches = 0


def conv2d_bias_act_backward(g: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, y: torch.Tensor, stride: int,
                             padding: str, act: Optional[str],
                             needs=(True, True, True)):
    """(dx, dw, dbias) of ``act(conv2d(x, w) + bias) = y`` at cotangent g,
    as the JAX ``_bwd`` computes them: ``gz = g·act'(y)`` in f32, cast to
    x's dtype; ``dbias = Σgz`` in f32; dx and dw are the gradients of the
    same asymmetrically padded conv (w cast to x's dtype), dw cast to w's
    dtype. Entries whose ``needs`` flag is False are None and are not
    computed. Plain differentiable PyTorch: the wali-gp penalty
    differentiates this function again."""
    kh, kw = w.shape[:2]
    (plo, phi), (qlo, qhi) = _pads(x.shape[1], x.shape[2], kh, kw, stride,
                                   padding)
    gz = (g.float() * activation_grad(act, y.float())).to(x.dtype)
    gz_nchw = gz.permute(0, 3, 1, 2)
    dx = dw = dbias = None
    if needs[0] or needs[1]:
        # NHWC viewed as channels-last NCHW: no copy to change layout
        xp = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
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


class FusedConv2dBiasAct(torch.autograd.Function):
    """The JAX ``fused_conv2d_bias_act`` with its custom VJP
    (``fused_conv.py:166-193``): K1 forward, saving ``(x, w, y)``; the
    backward (:func:`conv2d_bias_act_backward`) stays differentiable and
    computes only the gradients autograd asks for. It does not run the
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
        dx, dw, dbias = conv2d_bias_act_backward(
            g, x, w, y, *ctx.conf, needs=ctx.needs_input_grad[:3])
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dx, dw, dbias, None, None, None


def conv2d_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    stride: int = 1, padding: str = "SAME",
                    act: Optional[str] = None) -> torch.Tensor:
    """act(conv2d(x, w, stride, padding) + bias) with gradients.

    x: [B, H, W, Cin] contiguous NHWC; w: [KH, KW, Cin, Cout] (HWIO);
    bias: [Cout]. f32 or bf16; f32 accumulation; output in x's dtype.
    """
    return FusedConv2dBiasAct.apply(x, w, bias, stride, padding, act)
