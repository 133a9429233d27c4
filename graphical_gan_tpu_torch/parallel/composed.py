"""Composed parallelism (``graphical_gan_tpu/parallel/composed.py``): one
step factory over any subset of the ``data``, ``seq`` and ``model`` axes.

DP is ``(data,)``, TP ``(data, model)``, SP ``(data, seq)``, and the full
``(data, seq, model)`` runs the video family with its frame networks on
each rank's block of frames (``parallel/sequence.py``) and every conv's
channels in slices over ``model`` (``parallel/sharding_rules.py``). The
batch group (BN statistics, gradient mean) is ``data`` x ``seq``; the
parameters of ``tp_param_shardings`` are held in slices over ``model``.
"""

from __future__ import annotations

from typing import Optional

from graphical_gan_tpu_torch.parallel.sharding_rules import (
    tp_param_shardings)


def make_composed_train_step(model, mesh,
                             data_axis: Optional[str] = "data",
                             seq_axis: Optional[str] = None,
                             model_axis: Optional[str] = None,
                             lr_scale=None):
    """The step over ``mesh`` with any of DP/SP/TP active; every named
    axis must be in the mesh. Returns ``(step, init_state, place,
    gather_state)`` as ``parallel/mesh.py: make_sharded_step``."""
    from graphical_gan_tpu_torch.parallel.mesh import make_sharded_step
    for ax in (data_axis, seq_axis, model_axis):
        if ax is not None and ax not in mesh.shape:
            raise ValueError(f"mesh has axes {tuple(mesh.shape)}, "
                             f"missing {ax!r}")
    if seq_axis is not None and \
            model.cfg.seq_len % mesh.shape[seq_axis]:
        raise ValueError(f"LEN {model.cfg.seq_len} does not split over "
                         f"{mesh.shape[seq_axis]} seq ranks")
    shardings = None
    if model_axis is not None:
        def shardings(params):
            return tp_param_shardings(params, mesh, model_axis)
    return make_sharded_step(
        model, mesh, stats_axes=tuple(a for a in (data_axis, seq_axis)
                                      if a is not None),
        seq_axis=seq_axis, model_axis=model_axis, shardings=shardings,
        lr_scale=lr_scale)
