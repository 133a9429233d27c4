"""Batch normalization with batch statistics (``graphical_gan_tpu/ops/
norm.py:45-101``); eps 1e-5.

The "every axis but the last" form (the conv case, and the dense case
``axes=[0]`` on ``[B, F]``) goes through ``FusedBatchNormAct``
(``ops/kernels/fused_norm.py``): the K2a/K2b kernels forward and the one
K2c+K2d kernel backward, statistics in f32, output back in x's dtype, as
``ops/norm.py:84-89``. Other reduction axes keep the reference's keepdims
parameter shapes and run as plain tensor math (autograd's gradients).

``batchnorm_moving_stats``, ``layernorm`` and ``cond_batchnorm`` (no model
uses them; ``ops/norm.py:104-206``) are plain tensor math with autograd's
gradients, as the JAX package computes them in plain ``jnp``. The moving
statistics are explicit inputs and outputs, never parameters (the
reference marked them ``trainable=False``).

Under a parallel step (``parallel/context.py``) the batch statistics are
those of the whole batch, whose rows lie on every rank of the batch group
(K2a and K2c+K2d in their split modes), as GSPMD's mean over a sharded
batch is in JAX; under TP a BN whose channels are held in slices
normalizes the rank's channels and gathers them again.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.kernels.fused_norm import (
    EPS, batchnorm_act_q8, fused_batchnorm_act)
from graphical_gan_tpu_torch.parallel import collectives as col
from graphical_gan_tpu_torch.parallel import context as shard_ctx


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
        # the batch group where the batch's rows lie on several ranks
        stats = shard_ctx.stats_group()
        kw = {} if stats is None else {"group": stats}
        s_q = quant.bn_consumer_scale(name)
        if s_q is not None:
            y, q = batchnorm_act_q8(x.contiguous(), scale, offset, act, s_q,
                                    EPS, **kw)
            quant.bn_produced(name, y, q)
            return y
        tp = shard_ctx.model_shard(name + ".scale")
        if tp is not None:
            # TP holds this BN's channels in slices: its statistics are the
            # rank's channels' own, then the channels are gathered again
            group, _ = tp
            xs = col.slice_replicated(x, group, dim=-1)
            y = fused_batchnorm_act(xs, scale, offset, act, EPS, **kw)
            return col.gather_replicated(y, group, dim=-1)
        y = fused_batchnorm_act(x.contiguous(), scale, offset, act, EPS,
                                **kw)
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
    group = shard_ctx.stats_group() if 0 in axes else None
    if group is None:
        mean = x32.mean(dim=axes, keepdim=True)
        var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    else:  # the batch's rows lie on every rank of the group
        n = int(np.prod([x.shape[a] for a in axes])) * group.size
        mean = col.group_sum(x32.sum(dim=axes, keepdim=True), group) / n
        var = col.group_sum((x32 - mean).square().sum(dim=axes,
                                                      keepdim=True),
                            group) / n
    inv = torch.rsqrt(var + EPS) * params[name + ".scale"]
    return ((x32 - mean) * inv + params[name + ".offset"]).to(x.dtype)


def batchnorm_specs(name: str, c: int) -> Dict[str, Tuple]:
    """A batchnorm's ``name.offset`` (zeros) and ``name.scale`` (ones) over
    ``c`` channels; ``batchnorm_moving_stats`` takes the same."""
    return {name + ".offset": ("zeros", (c,), ()),
            name + ".scale": ("ones", (c,), ())}


def batchnorm_moving_stats(params: Dict[str, torch.Tensor], name: str,
                           x: torch.Tensor, is_training, stats_iter,
                           moving_mean: torch.Tensor,
                           moving_var: torch.Tensor,
                           update_moving_stats: bool = True):
    """The reference's moving-statistics BN (``tflib/ops/batchnorm.py:
    26-68``; ``graphical_gan_tpu/ops/norm.py:104-162``), which no
    reference script reaches. Returns ``(out, new_moving_mean,
    new_moving_var)`` for channels-last x:

    - training: batch-statistics normalization (eps 1e-5); the moving
      statistics updated with the reference's 1/(t+1) running mean over
      ``stats_iter`` t, with the batch variance Bessel-corrected;
    - inference: the reference's blended mode (``:32-37``), each item's
      spatial moments mixed with the moving statistics at weights
      (1/B, (B-1)/B).
    """
    scale, offset = params[name + ".scale"], params[name + ".offset"]
    x32 = x.float()
    red = tuple(range(x.ndim - 1))
    spatial = tuple(range(1, x.ndim - 1))
    if bool(is_training):
        mean = x32.mean(dim=red)
        var = (x32 - mean).square().mean(dim=red)
        out = (x32 - mean) * (torch.rsqrt(var + EPS) * scale) + offset
        if not update_moving_stats:
            return out.to(x.dtype), moving_mean, moving_var
        n = np.float32(np.prod([x.shape[a] for a in red]))
        var_unbiased = var * (n / max(n - np.float32(1.0), np.float32(1.0)))
        t = torch.as_tensor(stats_iter, dtype=torch.float32,
                            device=x.device)
        new_mean = (t / (t + 1.0)) * moving_mean + (1.0 / (t + 1.0)) * mean
        new_var = (t / (t + 1.0)) * moving_var \
            + (1.0 / (t + 1.0)) * var_unbiased
        return out.to(x.dtype), new_mean, new_var
    b = np.float32(x.shape[0])
    if spatial:
        item_mean = x32.mean(dim=spatial, keepdim=True)
        item_var = (x32 - item_mean).square().mean(dim=spatial,
                                                   keepdim=True)
    else:  # [B, C]: each item's moments over no axes (torch would reduce
        # over every axis for an empty dim)
        item_mean, item_var = x32, torch.zeros_like(x32)
    mean = (1.0 / b) * item_mean + ((b - 1.0) / b) * moving_mean
    var = (1.0 / b) * item_var + ((b - 1.0) / b) * moving_var
    out = (x32 - mean) * torch.rsqrt(var + EPS) * scale + offset
    return out.to(x.dtype), moving_mean, moving_var


def layernorm(params: Dict[str, torch.Tensor], name: str,
              norm_axes: Sequence[int], x: torch.Tensor) -> torch.Tensor:
    """Layer norm with a per-neuron offset and scale (``tflib/ops/
    layernorm.py:6-20``): ``norm_axes[0]`` is the neurons axis, whose size
    is the parameters'; they broadcast over the other normalized axes."""
    norm_axes = tuple(norm_axes)
    x32 = x.float()
    mean = x32.mean(dim=norm_axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=norm_axes, keepdim=True)
    bshape = [1] * x.ndim
    bshape[norm_axes[0]] = x.shape[norm_axes[0]]
    offset = params[name + ".offset"].reshape(bshape)
    scale = params[name + ".scale"].reshape(bshape)
    inv = torch.rsqrt(var + EPS) * scale
    return ((x32 - mean) * inv + offset).to(x.dtype)


def layernorm_specs(name: str, n_neurons: int) -> Dict[str, Tuple]:
    return batchnorm_specs(name, n_neurons)


def cond_batchnorm(params: Dict[str, torch.Tensor], name: str,
                   x: torch.Tensor, labels: torch.Tensor,
                   n_labels: int) -> torch.Tensor:
    """Conditional BN (Dumoulin) of NHWC conv maps (``tflib/ops/
    cond_batchnorm.py:6-17``): batch statistics per channel, then each
    item's label's offset and scale rows of ``name.offset`` /
    ``name.scale`` ``[n_labels, C]``."""
    offset_m, scale_m = params[name + ".offset"], params[name + ".scale"]
    if offset_m.shape[0] != n_labels:
        raise ValueError(f"{name}.offset has {offset_m.shape[0]} rows, "
                         f"not n_labels = {n_labels}")
    offset = offset_m[labels]
    scale = scale_m[labels]
    x32 = x.float()
    mean = x32.mean(dim=(0, 1, 2))
    var = (x32 - mean).square().mean(dim=(0, 1, 2))
    out = (x32 - mean) * torch.rsqrt(var + EPS)
    return (out * scale[:, None, None, :]
            + offset[:, None, None, :]).to(x.dtype)


def cond_batchnorm_specs(name: str, n_labels: int, c: int
                         ) -> Dict[str, Tuple]:
    return {name + ".offset": ("zeros", (n_labels, c), ()),
            name + ".scale": ("ones", (n_labels, c), ())}


def weight_normalized(w: torch.Tensor, g: torch.Tensor, norm_axes
                      ) -> torch.Tensor:
    """w scaled by g over its L2 norms across ``norm_axes``, one norm per
    output channel: the weight normalization of the JAX ``conv2d``,
    ``deconv2d``, ``conv1d`` and ``linear`` (``ops/conv.py:97-104``,
    ``ops/linear.py:45-55``)."""
    norms = torch.sqrt(torch.sum(torch.square(w), dim=norm_axes,
                                 keepdim=True))
    return w * (g.reshape(norms.shape) / norms)
