"""Data parallelism over ``torch.distributed`` (``graphical_gan_tpu/
parallel/mesh.py``), and the machinery every strategy shares.

JAX runs one program over a ``jax.sharding.Mesh`` and GSPMD inserts the
collectives; the port runs one process per rank (``torchrun``) and a
:class:`Mesh` names this rank's place on the axes ``data``, ``seq``,
``model`` and ``expert`` (``torch.distributed.device_mesh.
init_device_mesh`` makes one process group per axis). NCCL runs on
``cuda``, gloo with ``--device cpu``; ``devices=`` puts several ranks on
one card (over gloo: NCCL refuses two ranks on one device).

DP keeps the reference's semantics exactly, as JAX's does ("DP is
numerically a pure batch-partitioning"):

- every rank draws the global batch's noise from the one seed of the
  iteration and keeps its rows (``models/common.py: Draws``), and takes
  its rows of the global batch of data (:func:`shard_batch`);
- batch-statistics BN runs over the whole batch (``ops/norm.py``: K2a and
  K2c+K2d in their split modes), and the batch-coupled objectives gather
  their inputs (``core/shard_ctx.py: gather_batch``);
- each rank's loss is the mean over its rows, and a replicated
  parameter's gradient is the mean over the group, summed in rank order
  (``collectives.sum_in_rank_order``) so the replicas stay bit-identical;
  Adam, the wgan clip and the trainer's divergence guard then run on
  identical values on every rank.

:func:`make_sharded_step` is the one step factory under the strategies
(``sharding_rules.py``, ``sequence.py``, ``expert.py``, ``composed.py``):
which axes hold distinct rows, which parameters are held in slices, and
the context the step runs under. It returns ``(step, init_state, place)``
as the JAX factories do, ``step`` with the signature of
``train/step.py: make_train_step``'s, plus ``gather_state``, the full
state from the slices (checkpoints; ``train/checkpoint.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from graphical_gan_tpu_torch.core import tree
from graphical_gan_tpu_torch.parallel import context
from graphical_gan_tpu_torch.parallel.collectives import (
    Group, broadcast, gather_stack, sum_in_rank_order)

AXES = ("data", "seq", "model", "expert", "stage")
# the separator before a parameter's name in a checkpoint keypath
SEP_K = "|k:"


def torchrun_line(n: int) -> str:
    return (f"torchrun --nproc-per-node {n} -m "
            "graphical_gan_tpu_torch.runs.gan_inference ...")


@dataclass
class Mesh:
    """This rank's place on the named axes: ``shape`` (axis -> size, in
    ``axis_names`` order, row-major over the world's ranks), ``coords``
    (axis -> this rank's index) and the device it computes on. ``host``
    is the world over gloo on CPU tensors (the world group itself where
    that is gloo): the trainer's agreements and barriers use it, so they
    wait for no device work."""
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    coords: Dict[str, int]
    device: torch.device
    rank: int
    world: Group
    _groups: Dict[Tuple[str, ...], Group] = field(default_factory=dict)
    host: Optional[Group] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def group(self, *axes: str) -> Optional[Group]:
        """The group of the ranks that share this rank's coordinates on
        every other axis (None for no axis); its order is row-major over
        ``axes``. Made when the mesh is (every rank makes every group)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if not axes:
            return None
        return self._groups[axes]


def _rank_lists(dims: Sequence[int], sel: Sequence[int]):
    """For each assignment of the unselected axes, the world ranks along
    the selected ones, row-major."""
    import itertools
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    rest = [i for i in range(len(dims)) if i not in sel]
    out = []
    for fixed in itertools.product(*[range(dims[i]) for i in rest]):
        base = sum(f * strides[i] for f, i in zip(fixed, rest))
        ranks = [base + sum(c * strides[i] for c, i in zip(cs, sel))
                 for cs in itertools.product(*[range(dims[i]) for i in sel])]
        out.append(ranks)
    return out


def _init_group(backend: str, n: int) -> None:
    if dist.is_initialized():
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and int(os.environ["WORLD_SIZE"]) == n:
        dist.init_process_group(backend)
        return
    raise RuntimeError(
        f"a {n}-rank mesh needs a process group of {n} ranks, one process "
        f"per rank, and this process is in none; launch it as "
        f"`{torchrun_line(n)}` (or call torch.distributed."
        "init_process_group first)")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              device: str = "cuda", devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh`: 1-D ``(axis,)`` over ``n_devices`` ranks
    (default the world) as JAX's ``make_mesh``, or ``shape`` over
    ``axis_names``. Outside a process group of that many ranks it
    initializes one from torchrun's environment, or raises with the
    torchrun line; it never runs on one device without saying so. The
    rank computes on ``devices[rank]`` where given, else
    ``cuda:{LOCAL_RANK}`` (``device`` "cuda", backend NCCL) or the CPU
    (gloo)."""
    if shape is None:
        if n_devices is None:
            n_devices = dist.get_world_size() if dist.is_initialized() \
                else int(os.environ.get("WORLD_SIZE", 1))
        shape, axis_names = (int(n_devices),), (axis,)
    shape = tuple(int(d) for d in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or any(a not in AXES
                                            for a in axis_names):
        raise ValueError(f"mesh axes {axis_names} over {shape}: each axis "
                         f"one of {AXES}")
    n = 1
    for d in shape:
        n *= d
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    _init_group(backend, n)
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"mesh {dict(zip(axis_names, shape))} needs {n} ranks, the "
            f"process group has {dist.get_world_size()}; launch it as "
            f"`{torchrun_line(n)}`")
    rank = dist.get_rank()
    if devices is not None:
        dev = torch.device(devices[rank])
    elif dev_type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=axis_names)
    coords = {a: int(dm.get_local_rank(a)) for a in axis_names}
    groups = {}
    for i, a in enumerate(axis_names):
        groups[(a,)] = Group(dm.get_group(a), shape[i], coords[a])
    # the batch group of SP (rows over data, frames over seq): both axes
    if "data" in axis_names and "seq" in axis_names:
        sel = [axis_names.index("data"), axis_names.index("seq")]
        mine = None
        for ranks in _rank_lists(shape, sel):
            pg = dist.new_group(ranks)
            if rank in ranks:
                mine = Group(pg, len(ranks), ranks.index(rank))
        groups[("data", "seq")] = mine
    world = Group(dist.group.WORLD, n, rank)
    host = world if n == 1 or "gloo" in dist.get_backend() else Group(
        dist.new_group(backend="gloo"), n, rank)
    return Mesh(axis_names, shape, coords, dev, rank, world, groups, host)


def shard_batch(mesh: Mesh, batch, axis: str = "data", batch_dim: int = 1,
                size: Optional[int] = None):
    """This rank's rows of stacked raw batches ``[(1+k), B, ...]`` (the
    batch dim split over ``axis`` in rank order), on the mesh's device;
    with ``size``, a leaf whose batch dim is not ``size`` (already a
    rank's rows) is kept whole."""
    g = mesh.group(axis)

    def own(x):
        x = torch.as_tensor(x)
        if g is not None and g.size > 1 and (
                size is None or x.shape[batch_dim] == size):
            x = _slice(x, g, batch_dim)
        return x.to(mesh.device)

    return tree.tree_map(own, batch)


def replicate(mesh: Mesh, tree_):
    """Rank 0's tensors on every rank (a broadcast from rank 0, so that
    replicas start bit-identical), on the mesh's device; a dict or list
    of tensors (nested), other leaves kept."""
    if isinstance(tree_, dict):
        return {k: replicate(mesh, v) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(replicate(mesh, v) for v in tree_)
    if not isinstance(tree_, torch.Tensor):
        return tree_
    x = tree_.detach().to(mesh.device).clone()
    return broadcast(x, mesh.world)


# -- the shared step factory ---------------------------------------------------

class _Sync:
    """The step's ``sync`` (``train/step.py``): gradients and costs
    averaged over the batch group, summed in rank order."""

    def __init__(self, group: Optional[Group]):
        self.group = group

    def grads(self, grads):
        g = self.group
        if g is None or g.size == 1:
            return grads
        flat = torch.cat([t.reshape(-1).float() for t in grads])
        flat = sum_in_rank_order(flat, g) / g.size
        out, at = [], 0
        for t in grads:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def loss(self, t):
        g = self.group
        if g is None or g.size == 1:
            return t
        return sum_in_rank_order(t.detach().float(), g) / g.size


def _slice(x: torch.Tensor, group: Group, axis: int) -> torch.Tensor:
    n = x.shape[axis] // group.size
    return x.narrow(axis, group.index * n, n).contiguous()


def _map_state(state, fn):
    """A TrainState with ``fn(name, tensor)`` on each parameter and each
    per-parameter optimizer leaf (moments, f32 masters); other leaves as
    they are."""
    def opt(o):
        return {k: ({n: fn(n, t) for n, t in v.items()}
                    if isinstance(v, dict) else v) for k, v in o.items()}

    return type(state)(params={n: fn(n, p) for n, p in state.params.items()},
                       gen_opt=opt(state.gen_opt),
                       disc_opt=opt(state.disc_opt) if state.disc_opt else {},
                       step=state.step)


def make_sharded_step(model, mesh: Mesh, *, stats_axes=("data",),
                      seq_axis: Optional[str] = None,
                      model_axis: Optional[str] = None,
                      expert_axis: Optional[str] = None,
                      shardings=None, lr_scale=None):
    """``(step, init_state, place, gather_state)`` of ``model`` on this
    rank of ``mesh``.

    ``stats_axes``: the axes whose ranks hold distinct rows of the batch
    (``data``; SP adds ``seq``, whose ranks hold distinct frames): BN
    statistics, the gradient mean and the costs run over them.
    ``shardings(params) -> {name: (axis name, dim)}``: the parameters held
    in slices along ``dim`` over that mesh axis (TP's ``model``, EP's
    ``expert``); their Adam moments and f32 masters alike.
    ``step(state, raw_batches, do_gen, generator=None, noise=None)`` takes
    the global batch ``[1+k, B, ...]`` (or this rank's rows of it) and the
    global draws, as the one-process step does."""
    from graphical_gan_tpu_torch.train.step import make_train_step

    stats = mesh.group(*[a for a in stats_axes if a in mesh.shape])
    rows = mesh.group("data")
    sync = _Sync(stats)
    base_step, init_state = make_train_step(model, lr_scale, sync=sync)
    layout: Dict[str, Tuple[Group, int]] = {}

    def sharding() -> context.Sharding:
        tp = {n: d for n, (g, d) in layout.items()
              if model_axis is not None and g is mesh.group(model_axis)}
        return context.Sharding(
            rows=rows, stats=stats,
            seq=mesh.group(seq_axis) if seq_axis else None,
            model=mesh.group(model_axis) if model_axis else None, tp=tp,
            expert=mesh.group(expert_axis) if expert_axis else None)

    batch = int(model.cfg.batch_size)

    def step(state, raw_batches, do_gen, generator=None, noise=None):
        raw = shard_batch(mesh, raw_batches, size=batch)
        with context.sharding(sharding()):
            return base_step(state, raw, do_gen, generator, noise)

    def place(state):
        """Rank 0's state on every rank, then each sliced parameter (and
        its optimizer leaves) cut to this rank's slice."""
        layout.clear()
        if shardings is not None:
            for n, (axis, dim) in shardings(state.params).items():
                g = mesh.group(axis)
                if g is not None and g.size > 1:
                    layout[n] = (g, dim)
        full = type(state)(params=replicate(mesh, state.params),
                           gen_opt=replicate(mesh, state.gen_opt),
                           disc_opt=replicate(mesh, state.disc_opt),
                           step=state.step)
        return _map_state(full, lambda n, t: _slice(t, *layout[n])
                          if n in layout and t.ndim > layout[n][1] else t)

    def gather_state(state):
        """The full state from the ranks' slices (every rank calls it)."""
        def full(n, t):
            if n not in layout or t.ndim <= layout[n][1]:
                return t
            g, dim = layout[n]
            return torch.cat(list(gather_stack(t.contiguous(), g).unbind(0)),
                             dim=dim)
        return _map_state(state, full)

    def shard_spec(state):
        """keypath -> (dim, index, count) of the leaves this rank holds in
        slices: each sliced parameter and its optimizer leaves
        (``train/checkpoint_orbax.py``)."""
        from graphical_gan_tpu_torch.train.checkpoint import state_leaves
        out = {}
        for key, leaf in state_leaves(state).items():
            name = key.rsplit(SEP_K, 1)[-1]
            if name in layout and key.split("|")[0] != "n:step":
                g, dim = layout[name]
                if torch.as_tensor(leaf).ndim > dim:
                    out[key] = (dim, g.index, g.size)
        return out

    step.layout = layout  # name -> (group, dim), set by place
    step.shard_spec = shard_spec
    return step, init_state, place, gather_state


def make_parallel_train_step(model, mesh: Mesh, lr_scale=None,
                             axis: str = "data"):
    """DP over ``axis`` (JAX's ``make_parallel_train_step``): the batch's
    rows split over the axis, parameters and optimizer states replicated.
    Returns ``(step, init_state, place, gather_state)``."""
    return make_sharded_step(model, mesh, stats_axes=(axis,),
                             lr_scale=lr_scale)
