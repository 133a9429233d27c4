"""2-D convolution, transpose convolution and 3-D convolution over
channels-last tensors (``graphical_gan_tpu/ops/conv.py``), with gradients.

Filters keep the JAX package's TF layouts: conv HWIO ``[K, K, in, out]``,
transpose conv ``[K, K, out, in]``, conv3d DHWIO ``[K_len, K, K, in,
out]``. Each casts the filter to the activation dtype, as ``ops/conv.py:72``
does.

- ``conv2d`` goes through ``conv2d_bias_act`` (``ops/kernels/
  fused_conv.py``): the K1 kernel forward, bias and activation fused into
  its epilogue, and a differentiable backward. On a CPU tensor the forward
  is its plain version.
- ``deconv2d`` is ``F.conv_transpose2d`` by default: the JAX package
  computes it outside any Pallas kernel (``ops/conv.py:181-184``). It runs
  on the NHWC tensor viewed as channels-last NCHW, so nothing is copied to
  change layout. TF's SAME transpose conv is the input-gradient of the
  asymmetrically padded forward conv (pads ``(lo, hi)``, ``lo <= hi``),
  while torch's ``padding`` is symmetric, so it runs with ``padding=0`` and
  crops ``lo`` from the low side. Its gradients are autograd's (cuDNN on
  the card). With ``GGAN_PHASE_DECONV`` on (``ops/phase_deconv.py:
  use_phase_deconv``, off by default, as in JAX's ``ops/conv.py:
  171-179``) a stride-2 deconv takes the phase route instead: one stride-1
  conv on K1 to 4x the channels, the bias in K1's epilogue, then a
  depth-to-space (``ops/phase_deconv.py``).
- ``conv3d`` is ``F.conv3d`` on the NDHWC tensor viewed as NCDHW: the JAX
  package runs it as a plain XLA convolution over DHWIO (``ops/conv.py:
  227-243``), with no Pallas kernel. TF's SAME pads are asymmetric (the odd
  pad goes high), so they are applied with ``F.pad`` first and the conv
  runs unpadded. Its gradients are autograd's (cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    conv2d_bias_act, same_pads)
from graphical_gan_tpu_torch.ops.phase_deconv import (
    conv_transpose_phase, use_phase_deconv)


def conv2d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           stride: int = 1, padding: str = "SAME",
           act: Optional[str] = None) -> torch.Tensor:
    """act(conv2d(x) + bias); x [B, H, W, Cin] NHWC, ``name.Filters`` HWIO,
    ``name.Biases`` [Cout]. Every conv of the ported networks has a bias;
    the JAX ``biases=False`` form comes when a caller needs it.

    Inside an int8 context (``ops/quant.py``) the product runs on Q1/Q2
    instead of K1, bias and act in Q2's epilogue in x's dtype, as JAX's
    ``ops/conv.py:114-126`` applies them."""
    w = params[name + ".Filters"]
    q = quant.intercept_conv2d(name, x, w, stride, padding,
                               params[name + ".Biases"], act)
    if q is not None:
        return q
    return conv2d_bias_act(x.contiguous(), w, params[name + ".Biases"],
                           stride, padding, act)


def deconv2d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
             stride: int = 2, padding: str = "SAME") -> torch.Tensor:
    """TF ``conv2d_transpose`` plus ``name.Biases``; x [B, H, W, in] ->
    [B, s*H, s*W, out] (SAME).

    ``name.Filters`` is ``[K, K, out, in]``: the forward conv's HWIO filter
    with in = out channels here. Torch's transpose-conv weight is that
    forward conv's OIHW filter, ``[in, out, K, K]``.
    """
    if padding != "SAME":
        raise NotImplementedError(
            "deconv2d ports the SAME padding the models use; VALID waits for "
            "a later slice of the port")
    w = params[name + ".Filters"]
    bias = params[name + ".Biases"]
    # serving-side int8 context (ops/quant.py), before the phase gate, as
    # JAX's ops/conv.py:167-179
    q = quant.intercept_deconv2d(name, x, w, stride, padding, bias)
    if q is not None:
        return q
    if stride == 2 and use_phase_deconv():
        return conv_transpose_phase(x, w, bias)
    return conv_transpose(x, w, bias, stride)


def conv_transpose(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   stride: int = 2) -> torch.Tensor:
    """``deconv2d``'s library route: TF's SAME ``conv2d_transpose`` of x
    [B, H, W, in] with the ``(k, k, out, in)`` filter w, plus bias, as
    ``F.conv_transpose2d`` (cuDNN on the card)."""
    k = w.shape[0]
    oh, ow = x.shape[1] * stride, x.shape[2] * stride
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    full = F.conv_transpose2d(xc, w.to(x.dtype).permute(3, 2, 0, 1),
                              stride=stride)
    lo_h = same_pads(oh, k, stride)[0]
    lo_w = same_pads(ow, k, stride)[0]
    out = full[:, :, lo_h:lo_h + oh, lo_w:lo_w + ow].permute(0, 2, 3, 1)
    return (out + bias.to(out.dtype)).contiguous()


def conv3d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           stride: int = 1, stride_len: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """conv3d(x) + bias; x [N, D, H, W, Cin] NDHWC, ``name.Filters`` DHWIO
    ``[K_len, K, K, in, out]``, ``name.Biases`` [Cout]; strides
    (``stride_len``, ``stride``, ``stride``). Returns NDHWC."""
    if padding != "SAME":
        raise NotImplementedError("conv3d ports the SAME padding the models "
                                  "use")
    w = params[name + ".Filters"]
    kd, kh, kw = w.shape[:3]
    pads = []
    # F.pad lists the last axis first: W, then H, then D
    for size, k, s in ((x.shape[3], kw, stride), (x.shape[2], kh, stride),
                       (x.shape[1], kd, stride_len)):
        pads.extend(same_pads(size, k, s))
    xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)  # NCDHW view, padded
    out = F.conv3d(xc, w.to(x.dtype).permute(4, 3, 0, 1, 2),
                   stride=(stride_len, stride, stride))
    out = out.permute(0, 2, 3, 4, 1)
    return (out + params[name + ".Biases"].to(out.dtype)).contiguous()
