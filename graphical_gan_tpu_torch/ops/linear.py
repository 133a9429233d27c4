"""Dense layer (``graphical_gan_tpu/ops/linear.py``).

``W`` is stored ``[in, out]`` as in the JAX package and cast to the
activation dtype before the product, as ``linear.py:64`` does. The product
is a plain ``torch.matmul``: the JAX package computes it outside any Pallas
kernel. With ``weightnorm`` the columns are scaled by ``name.g`` over their
L2 norms first (``linear.py:45-55``). Inside an int8 context
(``ops/quant.py``) the 2-D product runs on Q1/Q2 instead, as JAX's
``linear.py:59-69`` intercepts it.

Under TP (``parallel/sharding_rules.py``) a layer whose ``W`` is held in
column slices multiplies the replicated input by the rank's columns and
gathers the output's columns: the flat ``[B, out]`` whole again before
any reshape reads it (``Generator.Input``'s columns are a contiguous run
of the flat NHWC feature, not a channel slice).

``linear_specs`` gives the parameters with the JAX op's six init schemes:
lecun / glorot (the default) / he / glorot_he scaled-uniform, 'orthogonal'
and ``('uniform', r)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.ops.initializers import linear_stdev
from graphical_gan_tpu_torch.ops.norm import weight_normalized
from graphical_gan_tpu_torch.parallel import collectives as col
from graphical_gan_tpu_torch.parallel import context as shard_ctx


def linear(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           biases: bool = True, weightnorm: bool = False) -> torch.Tensor:
    w = params[name + ".W"]
    if weightnorm:
        w = weight_normalized(w, params[name + ".g"], (0,))
    b = params[name + ".b"] if biases else None
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    q = quant.intercept_linear(name, x2d, w, b)  # the bias in Q2's epilogue
    if q is not None:
        return q.reshape(*lead, w.shape[1])
    tp = shard_ctx.model_shard(name + ".W")
    if tp is not None:  # TP: the rank's output columns, then all of them
        x2d = col.copy_to_shards(x2d, tp[0])
    out = torch.matmul(x2d, w.to(x.dtype)).reshape(*lead, w.shape[1])
    if biases:
        out = out + b.to(out.dtype)
    if tp is not None:
        out = col.gather_replicated(out, tp[0], dim=-1)
    return out


def linear_specs(name: str, input_dim: int, output_dim: int,
                 biases: bool = True,
                 initialization: Optional[Union[str, Tuple[str, float]]]
                 = None,
                 weightnorm: bool = False, gain: float = 1.0
                 ) -> Dict[str, Tuple]:
    """``linear``'s parameters (``linear.py:24-57``). As in the JAX op, the
    reference's "orthogonal when square" default is dead code there, so
    the default is always Glorot."""
    shape = (input_dim, output_dim)
    if isinstance(initialization, tuple):
        if initialization[0] != "uniform":
            raise ValueError(f"Invalid initialization {initialization!r}")
        w = ("uniform", shape, (initialization[1], gain))
    elif initialization == "orthogonal":
        w = ("orthogonal", shape, (gain,))
    else:
        # an unknown scheme raises here, not at init time
        linear_stdev(initialization, input_dim, output_dim)
        w = ("linear", shape, (input_dim, output_dim, initialization, gain))
    specs = {name + ".W": w}
    if weightnorm:
        specs[name + ".g"] = ("norms", (output_dim,), (name + ".W", (0,)))
    if biases:
        specs[name + ".b"] = ("zeros", (output_dim,), ())
    return specs
