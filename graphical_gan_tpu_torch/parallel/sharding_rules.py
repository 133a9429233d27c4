"""Tensor parallelism over the ``model`` axis (``graphical_gan_tpu/
parallel/sharding_rules.py``): the same name rules, now placing each
parameter's slices on the ranks of the ``model`` group.

The DCGAN nets are channel-dominated, so the axis is the output channel:

- conv kernels HWIO: shard O (axis 3); the generator's transpose-conv
  kernels ``(H, W, out, in)``: shard out (axis 2); conv3d DHWIO: O;
- dense kernels ``[in, out]``: shard out;
- biases and BN offset/scale: shard their one (channel) axis;
- a dim under ``_MIN_SHARD`` or that the group does not divide stays
  whole, and so does GMGAN's ``.Mu`` (read by the prior product and the
  posterior's distances alike).

Each rank holds 1/M of a sharded parameter and of its Adam moments. A
sharded layer runs on the replicated input at its slice of the output
channels (K1 at the sharded Cout through ``plan()``; ``ops/conv.py``,
``ops/linear.py``) and gathers the channels for the next layer, which is
what XLA's alternation of all-gathers and sharded convs computes in JAX;
a BN on sharded channels normalizes the rank's channels with their own
statistics (``ops/norm.py``). The replicated rest of the program runs
identically on the model group's ranks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]

_MIN_SHARD = 8  # don't shard tiny channel dims


def _spec_for(name: str, shape, model_axis: str, mesh_size: int
              ) -> Tuple:
    """The JAX rule's PartitionSpec as a tuple: ``model_axis`` at the
    sharded dim, None elsewhere; ``()`` for a replicated parameter."""
    ndim = len(shape)

    def ok(dim_size):
        return dim_size >= _MIN_SHARD and dim_size % mesh_size == 0

    def at(dim):
        spec = [None] * ndim
        spec[dim] = model_axis
        return tuple(spec)

    if name.endswith(".Mu"):
        return ()
    if name.endswith(".Filters") and ndim == 4:
        if name.startswith("Generator."):
            return at(2) if ok(shape[2]) else ()
        return at(3) if ok(shape[3]) else ()
    if name.endswith(".Filters") and ndim == 5:  # conv3d DHWIO
        return at(4) if ok(shape[4]) else ()
    if name.endswith(".W") and ndim == 2:
        return at(1) if ok(shape[1]) else ()
    if ndim == 1 and ok(shape[0]):
        return at(0)
    return ()


def tp_param_shardings(params: Params, mesh, model_axis: str = "model"
                       ) -> Dict[str, Tuple[str, int]]:
    """{name: (model_axis, the sharded dim)} of the parameters TP holds in
    slices over ``mesh``'s ``model_axis``; the others are replicated."""
    size = mesh.shape[model_axis]
    out = {}
    for n, p in params.items():
        spec = _spec_for(n, tuple(p.shape), model_axis, size)
        if spec:
            out[n] = (model_axis, spec.index(model_axis))
    return out


def make_tp_train_step(model, mesh, data_axis: str = "data",
                       model_axis: str = "model", lr_scale=None):
    """TP over a ``(data, model)`` mesh: the batch's rows over ``data``,
    the parameters of :func:`tp_param_shardings` in slices over
    ``model``. Returns ``(step, init_state, place, gather_state)`` as
    ``parallel/mesh.py: make_sharded_step``."""
    from graphical_gan_tpu_torch.parallel.mesh import make_sharded_step
    return make_sharded_step(
        model, mesh, stats_axes=(data_axis,), model_axis=model_axis,
        shardings=lambda params: tp_param_shardings(params, mesh,
                                                    model_axis),
        lr_scale=lr_scale)
