"""2-D, transpose-2-D, 1-D and 3-D convolution over channels-last tensors
(``graphical_gan_tpu/ops/conv.py``), with gradients.

Filters keep the JAX package's TF layouts: conv HWIO ``[K, K, in, out]``,
transpose conv ``[K, K, out, in]``, conv1d WIO ``[K, in, out]``, conv3d
DHWIO ``[K_len, K, K, in, out]``. Each casts the filter to the activation
dtype, as ``ops/conv.py:72`` does. Where the JAX op takes ``weightnorm``,
the filter is scaled by ``name.g`` over its per-output-channel L2 norms
first; where it takes ``mask_type`` (``(type, n_channels)``, PixelCNN's
causal masks 'a' and 'b', ``tflib/ops/conv2d.py:29-52``), the mask is
applied after that. ``biases=False`` leaves ``name.Biases`` out. The
``*_specs`` functions give each op's parameters as ``ops/initializers.py:
init_params`` specs, with the JAX op's fan arithmetic.

- ``conv2d`` goes through ``conv2d_bias_act`` (``ops/kernels/
  fused_conv.py``): the K1 kernel forward, bias and activation fused into
  its epilogue (a zero bias where ``biases=False``), and a differentiable
  backward. On a CPU tensor the forward is its plain version.
- ``deconv2d`` is ``F.conv_transpose2d`` by default: the JAX package
  computes it outside any Pallas kernel (``ops/conv.py:181-184``). It runs
  on the NHWC tensor viewed as channels-last NCHW, so nothing is copied to
  change layout. TF's SAME transpose conv is the input-gradient of the
  asymmetrically padded forward conv (pads ``(lo, hi)``, ``lo <= hi``),
  while torch's ``padding`` is symmetric, so it runs with ``padding=0`` and
  crops ``lo`` from the low side. VALID is the whole transposed conv,
  ``(H-1)·s + k``, padded high to ``lax.conv_transpose``'s ``H·s +
  max(k - s, 0)`` (``output_padding`` where k < s). Its gradients are
  autograd's (cuDNN on the card). With ``GGAN_PHASE_DECONV`` on
  (``ops/phase_deconv.py: use_phase_deconv``, off by default, as in JAX's
  ``ops/conv.py: 171-179``) a stride-2 SAME deconv takes the phase route
  instead: one stride-1 conv on K1 to 4x the channels, the bias in K1's
  epilogue, then a depth-to-space (``ops/phase_deconv.py``).
- Under TP (``parallel/sharding_rules.py``) ``conv2d`` and ``deconv2d``
  whose filter is held in slices of its output channels run at the rank's
  slice (K1 at the sharded Cout, through its ``plan()``) on the replicated
  input, and gather the output channels (``parallel/collectives.py``:
  the input's gradient summed over the ranks, the output's sliced).
- ``conv1d`` is ``F.conv1d`` on the NWC tensor viewed as NCW, TF's SAME
  pads applied first, as the JAX package computes it outside any Pallas
  kernel (``ops/conv.py:192-224``).
- ``conv3d`` is ``F.conv3d`` on the NDHWC tensor viewed as NCDHW: the JAX
  package runs it as a plain XLA convolution over DHWIO (``ops/conv.py:
  227-243``), with no Pallas kernel. TF's SAME pads are asymmetric (the odd
  pad goes high), so they are applied with ``F.pad`` first and the conv
  runs unpadded. Its gradients are autograd's (cuDNN on the card).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    conv2d_bias_act, same_pads)
from graphical_gan_tpu_torch.ops.norm import weight_normalized
from graphical_gan_tpu_torch.ops.phase_deconv import (
    conv_transpose_phase, use_phase_deconv)
from graphical_gan_tpu_torch.parallel import collectives as col
from graphical_gan_tpu_torch.parallel import context as shard_ctx


Specs = Dict[str, Tuple[str, Tuple[int, ...], Tuple]]


@functools.lru_cache(maxsize=None)
def _mask(mask_type: str, mask_n_channels: int, filter_shape: Tuple[int, ...]
          ) -> np.ndarray:
    """The causal filter mask (``tflib/ops/conv2d.py:29-52``,
    ``conv1d.py:20-41``) for a ``[K, K, in, out]`` or ``[K, in, out]``
    filter: the taps after the centre are 0, and at the centre the
    channel groups the type excludes ('a': i >= j, 'b': i > j)."""
    mask = np.ones(filter_shape, dtype=np.float32)
    center = filter_shape[0] // 2
    mask[center + 1:] = 0.0
    at = (center,)
    if len(filter_shape) == 4:
        mask[center, center + 1:] = 0.0
        at = (center, center)
    for i in range(mask_n_channels):
        for j in range(mask_n_channels):
            if (mask_type == "a" and i >= j) or (mask_type == "b" and i > j):
                mask[at + (slice(i, None, mask_n_channels),
                           slice(j, None, mask_n_channels))] = 0.0
    mask.setflags(write=False)
    return mask


def _filter(params: Dict[str, torch.Tensor], name: str, norm_axes,
            weightnorm: bool, mask_type=None) -> torch.Tensor:
    """``name.Filters`` with weight normalization (``name.g``) and the
    causal mask applied, in JAX's order (``ops/conv.py:97-111``)."""
    w = params[name + ".Filters"]
    if weightnorm:
        w = weight_normalized(w, params[name + ".g"], norm_axes)
    if mask_type is not None:
        mtype, mchan = mask_type
        w = w * torch.tensor(_mask(mtype, mchan, tuple(w.shape)),
                             device=w.device)
    return w


def conv2d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           stride: int = 1, padding: str = "SAME",
           act: Optional[str] = None, mask_type=None,
           weightnorm: bool = False, biases: bool = True) -> torch.Tensor:
    """act(conv2d(x) + bias); x [B, H, W, Cin] NHWC, ``name.Filters`` HWIO,
    ``name.Biases`` [Cout] (a zero bias in K1's epilogue where ``biases``
    is False).

    Inside an int8 context (``ops/quant.py``) the product runs on Q1/Q2
    instead of K1, bias and act in Q2's epilogue in x's dtype, as JAX's
    ``ops/conv.py:114-126`` applies them."""
    w = _filter(params, name, (0, 1, 2), weightnorm, mask_type)
    bias = params[name + ".Biases"] if biases else torch.zeros(
        w.shape[-1], device=w.device)
    q = quant.intercept_conv2d(name, x, w, stride, padding, bias, act)
    if q is not None:
        return q
    tp = shard_ctx.model_shard(name + ".Filters")
    if tp is None:
        return conv2d_bias_act(x.contiguous(), w, bias, stride, padding, act)
    # TP: K1 at the rank's slice of the output channels, then all of them
    y = conv2d_bias_act(col.copy_to_shards(x, tp[0]).contiguous(), w, bias,
                        stride, padding, act)
    return col.gather_replicated(y, tp[0], dim=-1)


def conv2d_specs(name: str, input_dim: int, output_dim: int,
                 filter_size: int, he_init: bool = True, mask_type=None,
                 stride: int = 1, weightnorm: bool = False,
                 biases: bool = True, gain: float = 1.0) -> Specs:
    """``conv2d``'s parameters (``ops/conv.py:80-95``)."""
    k = filter_size
    specs = {name + ".Filters": (
        "conv", (k, k, input_dim, output_dim),
        (input_dim, output_dim, k, stride, mask_type is not None, he_init,
         gain))}
    if weightnorm:
        specs[name + ".g"] = ("norms", (output_dim,),
                              (name + ".Filters", (0, 1, 2)))
    if biases:
        specs[name + ".Biases"] = ("zeros", (output_dim,), ())
    return specs


def deconv2d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
             stride: int = 2, padding: str = "SAME",
             weightnorm: bool = False, biases: bool = True) -> torch.Tensor:
    """TF ``conv2d_transpose`` plus ``name.Biases``; x [B, H, W, in] ->
    [B, s*H, s*W, out] (SAME) or [B, H*s + max(k - s, 0), ..., out]
    (VALID, as ``lax.conv_transpose``).

    ``name.Filters`` is ``[K, K, out, in]``: the forward conv's HWIO filter
    with in = out channels here. Torch's transpose-conv weight is that
    forward conv's OIHW filter, ``[in, out, K, K]``.
    """
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    w = _filter(params, name, (0, 1, 3), weightnorm)
    bias = params[name + ".Biases"] if biases else None
    # serving-side int8 context (ops/quant.py), before the phase gate, as
    # JAX's ops/conv.py:167-179
    q = quant.intercept_deconv2d(name, x, w, stride, padding, bias)
    if q is not None:
        return q
    tp = shard_ctx.model_shard(name + ".Filters")
    if tp is not None:  # TP: the rank's slice of the output channels
        x = col.copy_to_shards(x, tp[0])
    if stride == 2 and padding == "SAME" and use_phase_deconv():
        y = conv_transpose_phase(x, w, bias)
    else:
        y = conv_transpose(x, w, bias, stride, padding)
    return y if tp is None else col.gather_replicated(y, tp[0], dim=-1)


def deconv2d_specs(name: str, input_dim: int, output_dim: int,
                   filter_size: int, he_init: bool = True,
                   weightnorm: bool = False, biases: bool = True,
                   gain: float = 1.0, stride: int = 2) -> Specs:
    """``deconv2d``'s parameters (``ops/conv.py:149-167``)."""
    k = filter_size
    specs = {name + ".Filters": (
        "deconv", (k, k, output_dim, input_dim),
        (input_dim, output_dim, k, stride, he_init, gain))}
    if weightnorm:
        specs[name + ".g"] = ("norms", (output_dim,),
                              (name + ".Filters", (0, 1, 3)))
    if biases:
        specs[name + ".Biases"] = ("zeros", (output_dim,), ())
    return specs


def conv_transpose(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: int = 2,
                   padding: str = "SAME") -> torch.Tensor:
    """``deconv2d``'s library route: TF's ``conv2d_transpose`` of x
    [B, H, W, in] with the ``(k, k, out, in)`` filter w, plus bias (none
    where ``bias`` is None), as ``F.conv_transpose2d`` (cuDNN on the
    card)."""
    k = w.shape[0]
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
    wt = w.to(x.dtype).permute(3, 2, 0, 1)
    if padding == "VALID":
        # lax.conv_transpose's VALID: the whole (H-1)*s + k, and zeros up to
        # H*s where k < s
        out = F.conv_transpose2d(xc, wt, stride=stride,
                                 output_padding=max(stride - k, 0))
        out = out.permute(0, 2, 3, 1)
    else:
        oh, ow = x.shape[1] * stride, x.shape[2] * stride
        full = F.conv_transpose2d(xc, wt, stride=stride)
        lo_h = same_pads(oh, k, stride)[0]
        lo_w = same_pads(ow, k, stride)[0]
        out = full[:, :, lo_h:lo_h + oh, lo_w:lo_w + ow].permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def conv1d(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           stride: int = 1, mask_type=None, weightnorm: bool = False,
           biases: bool = True) -> torch.Tensor:
    """conv1d(x) + bias with TF's SAME pads; x [B, W, Cin] NWC,
    ``name.Filters`` WIO ``[K, in, out]`` (``ops/conv.py:192-224``).
    Returns NWC."""
    w = _filter(params, name, (0, 1), weightnorm, mask_type)
    lo, hi = same_pads(x.shape[1], w.shape[0], stride)
    xc = F.pad(x.permute(0, 2, 1), (lo, hi))  # NCW view, padded
    out = F.conv1d(xc, w.to(x.dtype).permute(2, 1, 0), stride=stride)
    out = out.permute(0, 2, 1)
    if biases:
        out = out + params[name + ".Biases"].to(out.dtype)
    return out.contiguous()


def conv1d_specs(name: str, input_dim: int, output_dim: int,
                 filter_size: int, he_init: bool = True, mask_type=None,
                 stride: int = 1, weightnorm: bool = False,
                 biases: bool = True, gain: float = 1.0) -> Specs:
    """``conv1d``'s parameters (``ops/conv.py:197-214``)."""
    specs = {name + ".Filters": (
        "conv1d", (filter_size, input_dim, output_dim),
        (input_dim, output_dim, filter_size, stride, mask_type is not None,
         he_init, gain))}
    if weightnorm:
        specs[name + ".g"] = ("norms", (output_dim,),
                              (name + ".Filters", (0, 1)))
    if biases:
        specs[name + ".Biases"] = ("zeros", (output_dim,), ())
    return specs


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
