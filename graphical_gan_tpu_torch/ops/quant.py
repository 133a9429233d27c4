"""Post-training int8 quantization of the serving path
(``graphical_gan_tpu/ops/quant.py``).

The serving sampler's convolutions, transposed convolutions and dense
products consult a thread-local context right before their product
(``ops/conv.py``, ``ops/linear.py``); model code is unchanged.

Scheme (static PTQ, the JAX package's):

- weights: symmetric int8 per output channel, ``s_w = max(|w|)/127`` in
  f32 over every axis but the output one (axis 3 of a HWIO filter, axis 2
  of a transposed conv's ``(k, k, O, I)`` filter, axis 1 of a dense
  ``[in, out]`` weight), floored at 1e-12;
- activations: symmetric int8 per tensor, ``s_x`` from a calibration run
  of the sampler on prior latents (:func:`calibrating`, then
  :func:`scales_from_records`), floored at 1e-12;
- ``q = clip(round_half_even(f32(x) / f32(s)), -127, 127)`` (Q1,
  ``ops/kernels/quant.py: quantize_int8``), int8 x int8 products summed in
  int32 (Q2, ``int8_conv_packed``), then ``f32(acc) * (f32(s_x) * s_w)``
  cast to x's dtype; bias and activation follow in that dtype, in Q2's
  epilogue (``bias_act_plain`` is their plain version).

A transposed conv quantizes its whole ``(k, k, O, I)`` filter per ``o``
first. At stride 2 SAME it then gathers the int8 taps of its phase filter
(``ops/phase_deconv.py: _phase_kernel``): one stride-1 Q2 conv to 4·O
channels, each taking its ``o``'s factor and bias, then the
depth-to-space. Any other stride and padding runs ``lax.conv_transpose``'s
own definition: one stride-1 Q2 conv of the spatially flipped filter over
the zero-dilated int8 input (:func:`intercept_deconv2d`). A dense layer is a 1x1 Q2 conv over ``[M, 1, 1, K]``.
Each filter is kept K-major (``pack_filter``), as Q2 reads it.

With no context active (the default, and always in training) every
intercept returns None and the float path runs as it did. The weights are
quantized once per context's weight cache (``quantized(scales,
weights)``): a sampler built for int8 serving keeps one cache, so its
weights are quantized at its first call and reused after.

Q1 folded into the BN that produces its input: at a layer's first call
(its weights' cache miss), its intercept notes whether its input is the
output of the ``batchnorm_act`` that ran last (``ops/norm.py``), the same
tensor or a contiguous view of all of it (cifar10's ``Generator.2`` reads
BN1's output through a reshape). The two are then paired in the cache;
on later calls that BN runs K2b with its int8 copy at the layer's scale
(``fused_norm.bn_apply_q8``), and the layer takes that copy in place of a
Q1 launch. Other inputs (the latents, mnist's crop between BN2 and
``Generator.3``, celeba's BN-free generator) keep the standalone Q1.
"""

from __future__ import annotations

import json
import sys
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

from graphical_gan_tpu_torch.ops.kernels.fused_conv import _pads
from graphical_gan_tpu_torch.ops.kernels.quant import (
    int8_conv_packed, pack_filter, quantize_int8)

_state = threading.local()
SCALE_FLOOR = 1e-12
# the weight cache's entry of the BN -> consumer pairs (a tuple: no layer
# name)
PAIRS = ("bn pairs",)


def _mode() -> Optional[str]:
    return getattr(_state, "mode", None)


@contextmanager
def calibrating(records: Dict[str, float]):
    """Record each intercepted layer's input absmax into ``records``
    (eager runs only)."""
    if _mode() is not None:
        raise RuntimeError(f"quant context already active: {_mode()}")
    _state.mode, _state.records = "calib", records
    try:
        yield records
    finally:
        _state.mode = _state.records = None


@contextmanager
def quantized(scales: Dict[str, float],
              weights: Optional[Dict[str, tuple]] = None):
    """Run the intercepted layers on the int8 path with the calibrated
    activation ``scales``. ``weights`` is the cache of quantized weights
    by layer name; pass the same dict to every call of one sampler to
    quantize its weights once."""
    if _mode() is not None:
        raise RuntimeError(f"quant context already active: {_mode()}")
    _state.mode, _state.scales = "int8", dict(scales)
    _state.weights = {} if weights is None else weights
    # the last BN output (a pairing candidate) and the paired BNs' int8
    # copies by consumer
    _state.last_bn, _state.pending = None, {}
    try:
        yield
    finally:
        _state.mode = _state.scales = _state.weights = None
        _state.last_bn = _state.pending = None


def _traced(x) -> bool:
    """A FakeTensor (torch.export's tracing) or a torch.compile trace; a
    process that never imported the fake-tensor module holds none."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return ((fake is not None and isinstance(x, fake.FakeTensor))
            or torch.compiler.is_compiling())


def _record(name: str, x: torch.Tensor) -> None:
    if _traced(x):
        raise RuntimeError(
            "quant calibration must run eagerly (not under torch.compile "
            f"or torch.export) so input ranges can be read; layer {name!r} "
            "saw a traced tensor")
    records = _state.records
    absmax = float(x.detach().abs().max())
    records[name] = max(absmax, records.get(name, 0.0))


def _act_scale(name: str) -> float:
    try:
        s = _state.scales[name]
    except KeyError:
        raise KeyError(
            f"no calibrated activation scale for layer {name!r} — the "
            "calibration run did not cover this layer (model/config "
            "mismatch between calibrate and quantize?)")
    return max(float(s), SCALE_FLOOR)


def weight_scales(w: torch.Tensor, out_axis: int) -> torch.Tensor:
    """``max(|w|)/127`` over every axis but ``out_axis``, floored at 1e-12,
    in w's dtype (JAX's ``_w_scales``). The divisor is a tensor on w's
    device: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which is not the IEEE quotient JAX computes."""
    axes = tuple(i for i in range(w.ndim) if i != out_axis)
    qmax = torch.tensor(127.0, dtype=w.dtype, device=w.device)
    return torch.clamp_min(w.abs().amax(dim=axes) / qmax, SCALE_FLOOR)


def _factor(s_x: float, s_w: torch.Tensor) -> torch.Tensor:
    """``f32(s_x) * s_w`` as JAX's weak typing computes it (in s_w's
    dtype), then f32 for Q2's epilogue."""
    return (torch.tensor(s_x, dtype=s_w.dtype, device=s_w.device) * s_w
            ).float()


def _prepared(name: str, w: torch.Tensor, kind: str, s_x: float):
    """(K-major int8 filter, f32 factor, made now) of layer ``name``, from
    the context's cache while ``w`` is the tensor it was made from, or is
    its trace (``torch.export`` of an entry whose cache an eager call
    filled: the program then holds the cached int8 weights as
    constants)."""
    cache = _state.weights
    hit = cache.get(name)
    if hit is not None and (hit[0] is w or _traced(w)) and hit[1] == s_x:
        return hit[2], hit[3], False
    if kind == "conv2d":          # HWIO
        s_w = weight_scales(w, 3)
        wq = quantize_int8(w.contiguous(), s_w.float(), axis=3)
        factor = _factor(s_x, s_w)
    elif kind == "deconv2d":      # (k, k, O, I): per o, then the phase taps
        from graphical_gan_tpu_torch.ops.phase_deconv import _phase_kernel
        s_w = weight_scales(w, 2)
        wq_full = quantize_int8(w.contiguous(), s_w.float(), axis=2)
        wq = _phase_kernel(wq_full, int(w.shape[0]))[0]
        factor = _factor(s_x, s_w).repeat(4)
    elif kind == "deconv2d_flip":  # (k, k, O, I): per o, then flipped HWIO
        s_w = weight_scales(w, 2)
        wq_full = quantize_int8(w.contiguous(), s_w.float(), axis=2)
        wq = wq_full.flip(0, 1).permute(0, 1, 3, 2).contiguous()
        factor = _factor(s_x, s_w)
    else:                         # linear [in, out] as a 1x1 HWIO filter
        s_w = weight_scales(w, 1)
        wq = quantize_int8(w.contiguous(), s_w.float(), axis=1)
        wq = wq.reshape(1, 1, *w.shape)
        factor = _factor(s_x, s_w)
    pf = pack_filter(wq)
    cache[name] = (w, s_x, pf, factor)
    return pf, factor, True


def _whole_view(x: torch.Tensor, y: torch.Tensor) -> bool:
    """x is y, or a contiguous view of all of y's elements."""
    return (x is y or (x.dtype == y.dtype and x.numel() == y.numel()
                       and x.is_contiguous() and y.is_contiguous()
                       and x.data_ptr() == y.data_ptr()))


def _input_q8(name: str, x: torch.Tensor, s_x: float,
              first: bool) -> torch.Tensor:
    """The int8 values of layer ``name``'s input x: its paired BN's int8
    copy where that BN made one for it, else Q1. At the layer's first
    call (``first``), pair it with the last BN if x is that BN's output."""
    pairs = _state.weights.setdefault(PAIRS, {})
    if first:
        last = _state.last_bn
        if last is not None and last[0] not in pairs and not _traced(x) \
                and _whole_view(x, last[1]):
            pairs[last[0]] = name
    else:
        made = _state.pending.pop(name, None)
        if made is not None and (_traced(x) or _whole_view(x, made[0])):
            return made[1].reshape(x.shape)
    return quantize_int8(x.contiguous(), s_x)


def bn_consumer_scale(bn: str) -> Optional[float]:
    """The activation scale of the int8 layer paired with BN ``bn`` (its
    output's int8 copy is made at it), or None: no int8 context, or no
    pair."""
    if _mode() != "int8":
        return None
    consumer = _state.weights.get(PAIRS, {}).get(bn)
    return None if consumer is None else _act_scale(consumer)


def bn_produced(bn: str, y: torch.Tensor,
                q: Optional[torch.Tensor] = None) -> None:
    """``ops/norm.py: batchnorm_act``'s output y of BN ``bn`` (and with
    ``q`` its int8 copy for the paired layer) under an int8 context."""
    if _mode() != "int8":
        return
    if q is None:
        _state.last_bn = (bn, y)
    else:
        _state.pending[_state.weights[PAIRS][bn]] = (y, q)


def intercept_conv2d(name: str, x: torch.Tensor, w: torch.Tensor,
                     stride: int, padding, bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> Optional[torch.Tensor]:
    """int8 path of ``ops.conv.conv2d`` (HWIO filter): ``act(conv + bias)``
    (without them where not given), or None where the float path runs (no
    context, or calibration after recording)."""
    mode = _mode()
    if mode is None:
        return None
    if mode == "calib":
        _record(name, x)
        return None
    s_x = _act_scale(name)
    pf, factor, first = _prepared(name, w, "conv2d", s_x)
    pads = _pads(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride,
                 padding)
    return int8_conv_packed(_input_q8(name, x, s_x, first), pf, factor,
                            stride, pads, x.dtype, bias, act)


def conv_transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """The edge pads of the stride-1 conv that ``lax.conv_transpose``
    runs over the input dilated by ``s`` (``s - 1`` zeros between rows and
    between columns): SAME gives ``H·s`` rows, VALID ``H·s + max(k - s,
    0)``."""
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    return lo, total - lo


def dilate_rows_cols(x: torch.Tensor, s: int) -> torch.Tensor:
    """NHWC x with ``s - 1`` zero rows and columns inserted between its
    rows and its columns: [B, (H-1)·s + 1, (W-1)·s + 1, C]."""
    if s == 1:
        return x
    b, h, w, c = x.shape
    out = x.new_zeros((b, (h - 1) * s + 1, (w - 1) * s + 1, c))
    out[:, ::s, ::s, :] = x
    return out


def intercept_deconv2d(name: str, x: torch.Tensor, w: torch.Tensor,
                       stride: int, padding: str,
                       bias: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
    """int8 path of ``ops.conv.deconv2d`` (``(k, k, O, I)`` filter), as
    ``lax.conv_transpose(..., transpose_kernel=True)`` defines it.

    Stride 2 SAME takes the phase route: one stride-1 Q2 conv to 4·O
    channels (the bias tiled 4x into its epilogue where given), then the
    depth-to-space. Every other stride and padding runs one stride-1 Q2
    conv over the int8 input with ``stride - 1`` zero rows and columns
    inserted (an int8 0 is an exact quantized 0), the edge pads of
    :func:`conv_transpose_pads`, and the filter flipped spatially as an
    HWIO ``[k, k, I, O]`` filter; the int32 sums are exact and Q2's
    epilogue dequantizes per o and adds the bias."""
    mode = _mode()
    if mode is None:
        return None
    if mode == "calib":
        _record(name, x)
        return None
    s_x = _act_scale(name)
    if stride != 2 or padding != "SAME":
        pf, factor, first = _prepared(name, w, "deconv2d_flip", s_x)
        lo, hi = conv_transpose_pads(int(w.shape[0]), stride, padding)
        lo_w, hi_w = conv_transpose_pads(int(w.shape[1]), stride, padding)
        xq = dilate_rows_cols(_input_q8(name, x, s_x, first), stride)
        return int8_conv_packed(xq, pf, factor, 1, ((lo, hi), (lo_w, hi_w)),
                                x.dtype, bias)
    from graphical_gan_tpu_torch.ops.phase_deconv import _phase_plan
    pf, factor, first = _prepared(name, w, "deconv2d", s_x)
    pl, pr = _phase_plan(int(w.shape[0]))[:2]
    out4 = int8_conv_packed(_input_q8(name, x, s_x, first), pf, factor, 1,
                            ((pl, pr), (pl, pr)), x.dtype,
                            None if bias is None else bias.repeat(4))
    b, h, wd = out4.shape[:3]
    o = int(w.shape[2])
    out = out4.reshape(b, h, wd, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, 2 * h, 2 * wd, o)


def intercept_linear(name: str, x2d: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """int8 path of ``ops.linear.linear`` (2-D x, ``[in, out]`` weight), a
    1x1 Q2 conv over ``[M, 1, 1, K]``, + bias where given."""
    mode = _mode()
    if mode is None:
        return None
    if mode == "calib":
        _record(name, x2d)
        return None
    s_x = _act_scale(name)
    pf, factor, first = _prepared(name, w, "linear", s_x)
    m, k = x2d.shape
    xq = _input_q8(name, x2d, s_x, first).reshape(m, 1, 1, k)
    out = int8_conv_packed(xq, pf, factor, 1, "VALID", x2d.dtype, bias)
    return out.reshape(m, w.shape[1])


def scales_from_records(records: Dict[str, float]) -> Dict[str, float]:
    """Calibration absmax records to activation scales."""
    return {k: max(v, SCALE_FLOOR) / 127.0 for k, v in records.items()}


def save_scales(path: str, scales: Dict[str, float]) -> None:
    """The JAX package's ``act_scales.json`` format."""
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in scales.items()}, f, indent=1,
                  sort_keys=True)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}
