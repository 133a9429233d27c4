"""Phase-decomposed (subpixel) stride-2 transposed convolution
(``graphical_gan_tpu/ops/phase_deconv.py``).

A stride-2 SAME transposed conv is the adjoint of a stride-2 SAME conv.
Written per output parity, each output phase is a stride-1 correlation of
the input with the kernel taps of that parity, reversed; the four phases of
a 2-D output fit one common T x T window. So the whole deconv is ONE
stride-1 conv from I to 4·O channels (channel group g = 2a + b holds output
phase (row parity a, column parity b)), followed by a depth-to-space. At
k = 5 that is 9·4 = 36 multiply-adds per input pixel and channel pair
against the dilated form's 4·25 = 100.

Here that stride-1 conv runs on K1 (``ops/kernels/fused_conv.py:
conv2d_bias_act``): the bias, tiled 4x, is added in K1's epilogue, with no
activation; its gradients are K1's backward. On a CPU tensor K1 computes
its plain version. The phase filter is plain tensor code on the weights (a
gather of the transpose filter's taps and zeros).

``deconv2d`` (``ops/conv.py``) takes this route where
:func:`use_phase_deconv` says so; it is off by default, as in JAX, where
the rewrite lost on the TPU (``graphical_gan_tpu/ops/phase_deconv.py:
120-135``). ``tools/bench_phase_deconv.py`` measures it against the cuDNN
route on the card.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch

from graphical_gan_tpu_torch.ops.kernels.fused_conv import conv2d_bias_act


@functools.lru_cache(maxsize=None)
def _phase_plan(k: int):
    """The tap plan of one spatial axis at stride 2: ``(pl, pr, T, taps)``,
    taps[a] the ``(j, d)`` pairs where window position j reads the
    transpose kernel's tap d for output phase a (JAX's ``_phase_plan``)."""
    pad_lo = (k - 2) // 2
    t_rng = {}
    for a in (0, 1):
        # t such that 0 <= -2t + a + pad_lo <= k - 1
        t_rng[a] = (math.ceil((a + pad_lo - (k - 1)) / 2),
                    math.floor((a + pad_lo) / 2))
    t_min = min(r[0] for r in t_rng.values())
    t_max = max(r[1] for r in t_rng.values())
    pl, pr = -t_min, t_max
    T = t_max - t_min + 1
    taps = {}
    for a in (0, 1):
        taps[a] = tuple((j, -2 * (j - pl) + a + pad_lo) for j in range(T)
                        if 0 <= -2 * (j - pl) + a + pad_lo < k)
    return pl, pr, T, (taps[0], taps[1])


@functools.lru_cache(maxsize=None)
def _tap_index(k: int, device: torch.device) -> torch.Tensor:
    """[T, T, 4] indices into the k·k taps of the transpose kernel (k·k
    for a zero): window position (jh, jw) of channel group g = 2a + b; one
    copy per device, made outside inference mode whatever the first
    caller's mode (an int8 sampler under ``torch.inference_mode``), so a
    later differentiable call may save it for backward."""
    _, _, T, taps = _phase_plan(k)
    with torch.inference_mode(False):
        idx = torch.full((T, T, 4), k * k, dtype=torch.long)
        for a in (0, 1):
            for b in (0, 1):
                for jh, dh in taps[a]:
                    for jw, dw in taps[b]:
                        idx[jh, jw, 2 * a + b] = dh * k + dw
        return idx.to(device)


def _phase_kernel(w_oi: torch.Tensor, k: int):
    """The ``(T, T, I, 4·O)`` stride-1 HWIO filter from the TF-layout
    ``(k, k, O, I)`` transpose filter, and the window pads ``(pl, pr)``.
    Every tap of ``w_oi`` lands once, so the gather's gradient is exact."""
    pl, pr, T, _ = _phase_plan(k)
    o, i = w_oi.shape[2], w_oi.shape[3]
    # forward-conv orientation (k·k, I, O), then one zero tap
    taps = w_oi.permute(0, 1, 3, 2).reshape(k * k, i, o)
    taps = torch.cat([taps, taps.new_zeros((1, i, o))])
    big = taps[_tap_index(k, w_oi.device)]          # [T, T, 4, I, O]
    return big.permute(0, 1, 3, 2, 4).reshape(T, T, i, 4 * o), (pl, pr)


def conv_transpose_phase(x: torch.Tensor, w_oi: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """TF's ``conv2d_transpose`` at stride 2, SAME, plus ``bias``: x [B, H,
    W, I] NHWC, ``w_oi`` the ``(k, k, O, I)`` filter, output [B, 2H, 2W,
    O] in x's dtype. One stride-1 K1 conv to 4·O channels (the bias tiled
    4x into its epilogue), then a depth-to-space."""
    k = int(w_oi.shape[0])
    if w_oi.shape[1] != k:
        raise ValueError(f"square kernels only, got {tuple(w_oi.shape)}")
    o = int(w_oi.shape[2])
    big, (pl, pr) = _phase_kernel(w_oi, k)
    bias4 = (w_oi.new_zeros((4 * o,)) if bias is None else bias.repeat(4))
    out4 = conv2d_bias_act(x.contiguous(), big, bias4, 1,
                           ((pl, pr), (pl, pr)), None)
    b, h, wd = out4.shape[:3]
    out = out4.reshape(b, h, wd, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, 2 * h, 2 * wd, o)


def use_phase_deconv() -> bool:
    """The gate, read at call time: ``GGAN_PHASE_DECONV`` of ``0``,
    ``false`` or empty is off, any other value on; unset, the default
    (off, as in JAX)."""
    v = os.environ.get("GGAN_PHASE_DECONV")
    if v is not None:
        return v not in ("0", "false", "")
    return _DEFAULT_ON


# off until a benchmark on the card shows the route faster end to end
# (PERF.md; tools/bench_phase_deconv.py)
_DEFAULT_ON = False
