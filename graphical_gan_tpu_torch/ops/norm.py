"""Batch normalization with batch statistics (``graphical_gan_tpu/ops/
norm.py:45-101``); eps 1e-5.

The "every axis but the last" form (the conv case, and the dense case
``axes=[0]`` on ``[B, F]``) goes through ``FusedBatchNormAct``
(``ops/kernels/fused_norm.py``): the K2a/K2b kernels forward and the one
K2c+K2d kernel backward, statistics in f32, output back in x's dtype, as
``ops/norm.py:84-89``. Other reduction axes keep the reference's keepdims
parameter shapes and run as plain tensor math (autograd's gradients).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.kernels.fused_norm import (
    EPS, batchnorm_act_q8, fused_batchnorm_act)


def _is_channels_last(x: torch.Tensor, axes) -> bool:
    return axes is None or tuple(axes) == tuple(range(x.ndim - 1))


def batchnorm_act(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
                  act: Optional[str] = None,
                  axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``act(batchnorm(x))`` with learned ``name.scale`` / ``name.offset``.

    Under an int8 context (``ops/quant.py``) the channels-last form reports
    its output to the context, and where the context paired it with the
    int8 layer that reads it, also writes that layer's int8 copy in the
    same pass (``fused_norm.batchnorm_act_q8``)."""
    if _is_channels_last(x, axes):
        scale, offset = params[name + ".scale"], params[name + ".offset"]
        s_q = quant.bn_consumer_scale(name)
        if s_q is not None:
            y, q = batchnorm_act_q8(x.contiguous(), scale, offset, act, s_q,
                                    EPS)
            quant.bn_produced(name, y, q)
            return y
        y = fused_batchnorm_act(x.contiguous(), scale, offset, act, EPS)
        quant.bn_produced(name, y)
        return y
    return activation(act)(batchnorm(params, name, x, axes))


def batchnorm(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
              axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Batch-statistics normalization over ``axes`` of the channels-last x
    (default: every axis but the last)."""
    if _is_channels_last(x, axes):
        return batchnorm_act(params, name, x, None, axes)
    axes = tuple(axes)
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    inv = torch.rsqrt(var + EPS) * params[name + ".scale"]
    return ((x32 - mean) * inv + params[name + ".offset"]).to(x.dtype)
