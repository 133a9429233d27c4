"""The collectives the parallel strategies need, over ``torch.distributed``.

JAX's GSPMD derives every collective from sharding annotations; the port
runs one process per rank and calls them itself. Every collective here is
built from ``all_reduce(SUM)`` and ``broadcast``, the two collectives
PyTorch's backend table lists for gloo on CUDA tensors as well as for
NCCL (``chip_smoke.py``'s ``parallel`` phase records which others gloo
takes there), so one code path runs on NCCL across cards, on gloo with
several ranks on one card, and on gloo on the CPU:

- :func:`gather_stack` writes each rank's tensor into its row of a zero
  buffer and sums the buffers (:func:`all_reduce_stack`): each row is one
  rank's tensor plus zeros, exact (a -0 becomes +0); a producer that
  writes its row and the zeros itself (the BN statistics' slot form,
  ``ops/kernels/fused_norm.py: bn_stats_local``) hands its buffer to
  :func:`all_reduce_stack` directly;
- :func:`sum_in_rank_order` adds the gathered rows one after another in
  rank order, so every rank computes the same bits and replicas stay
  bit-identical, whatever order the backend reduces in.

Two families of differentiable collectives, each ``Function``'s backward
calling the other's ``apply``, so that a backward can be differentiated
again (the wali-gp penalty differentiates D's input gradient, collectives
included: ``objectives/penalties.py``):

- **Batch groups** (``data``, ``seq``): every rank computes its own loss
  term on its own rows, and a replicated parameter's gradient is the mean
  over the group (``parallel/mesh.py``). A tensor gathered for every rank
  (:func:`all_gather`) back-propagates the sum of the ranks' gradients to
  each owner's slice (a reduce-scatter), and the two are each other's
  adjoints; :func:`group_sum` (the cross-rank BN sums) is its own.
  :func:`shard_rows` (a rank's block of a tensor every rank holds) pads its
  gradient with zeros.
- **Replicated groups** (``model``, ``expert``): the ranks compute one
  replicated program, each holding a slice of some parameters. A tensor
  gathered from the slices (:func:`gather_replicated`) back-propagates
  only its own slice (:func:`slice_replicated`), since every rank already
  holds the whole gradient; a replicated input to a sharded product
  (:func:`copy_to_shards`) sums the ranks' partial input gradients, and a
  sum of partial products (:func:`reduce_from_shards`) passes its
  gradient through. ``torch.distributed.nn.functional``'s all_gather is
  differentiable twice too, but it back-propagates a reduce-scatter, the
  batch group's rule (a replicated consumer would get its input gradient
  summed M times), and on gloo through an all_to_all, which gloo does not
  take on CUDA tensors (``chip_smoke.py``'s ``parallel`` phase).

A ``group`` is a :class:`Group`; ``None`` or a group of one rank makes
every function the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """A process group, its size and this rank's index in it (ranks in
    the group's order, the order every gather and sum follows)."""
    pg: Any
    size: int
    index: int


def _trivial(group: Optional[Group]) -> bool:
    return group is None or group.size == 1


def all_reduce_stack(buf: torch.Tensor, group: Optional[Group]
                     ) -> torch.Tensor:
    """``buf`` [size, ...], in which this rank wrote its row and zeros in
    the others, with every rank's row: one ``all_reduce(SUM)`` in place
    (no gradient). The rows are :func:`gather_stack`'s, bit for bit."""
    if not _trivial(group):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    return buf


def gather_stack(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """[size, *x.shape]: row r is rank r's x (no gradient)."""
    if _trivial(group):
        return x.detach().unsqueeze(0)
    buf = x.new_zeros((group.size,) + tuple(x.shape))
    buf[group.index] = x.detach()
    return all_reduce_stack(buf, group)


def sum_in_rank_order(x: torch.Tensor, group: Optional[Group]
                      ) -> torch.Tensor:
    """The sum of the ranks' x, added in rank order (no gradient); every
    rank gets the same bits."""
    if _trivial(group):
        return x.detach()
    rows = gather_stack(x, group)
    acc = rows[0].clone()
    for r in range(1, group.size):
        acc += rows[r]
    return acc


def all_max(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The elementwise max over the ranks (no gradient)."""
    if _trivial(group):
        return x.detach()
    return gather_stack(x, group).amax(dim=0)


def broadcast(x: torch.Tensor, group: Optional[Group], src_index: int = 0
              ) -> torch.Tensor:
    """x of the group's rank ``src_index`` on every rank, in place."""
    if _trivial(group):
        return x
    dist.broadcast(x, src=dist.get_global_rank(group.pg, src_index),
                   group=group.pg)
    return x


def _cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    rows = gather_stack(x, group)
    return torch.cat(list(rows.unbind(0)), dim=dim)


def _own(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {group.size} ranks")
    step = n // group.size
    return x.narrow(dim, group.index * step, step).contiguous()


def _pad_own(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    step = shape[dim]
    shape[dim] = step * group.size
    out = x.new_zeros(shape)
    out.narrow(dim, group.index * step, step).copy_(x)
    return out


# -- batch groups -------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, *ctx.conf), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _own(sum_in_rank_order(x, group), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, *ctx.conf), None, None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_in_rank_order(x, group)

    @staticmethod
    def backward(ctx, g):
        return _GroupSum.apply(g, ctx.group), None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _PadRows.apply(g, *ctx.conf), None, None


class _PadRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _pad_own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _ShardRows.apply(g, *ctx.conf), None, None


def all_gather(x: torch.Tensor, group: Optional[Group], dim: int = 0
               ) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order, for every
    rank's own loss term; backward: the ranks' gradients summed, this
    rank's block of them."""
    return x if _trivial(group) else _AllGather.apply(x, group, dim)


def group_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The ranks' sum in rank order on every rank; backward: the same."""
    return x if _trivial(group) else _GroupSum.apply(x, group)


def shard_rows(x: torch.Tensor, group: Optional[Group], dim: int = 0
               ) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank holds;
    backward: the gradient padded with zeros."""
    return x if _trivial(group) else _ShardRows.apply(x, group, dim)


# -- replicated groups --------------------------------------------------------

class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _SliceReplicated.apply(g, *ctx.conf), None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.conf = (group, dim)
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _GatherReplicated.apply(g, *ctx.conf), None, None


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromShards.apply(g, ctx.group), None


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_in_rank_order(x, group)

    @staticmethod
    def backward(ctx, g):
        return _CopyToShards.apply(g, ctx.group), None


def gather_replicated(x: torch.Tensor, group: Optional[Group],
                      dim: int = -1) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``, consumed by the
    replicated program; backward: this rank's slice of the gradient."""
    if _trivial(group):
        return x
    return _GatherReplicated.apply(x, group, dim % x.ndim)


def slice_replicated(x: torch.Tensor, group: Optional[Group],
                     dim: int = -1) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor; backward:
    the gradient's slices gathered."""
    if _trivial(group):
        return x
    return _SliceReplicated.apply(x, group, dim % x.ndim)


def copy_to_shards(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """A replicated input to a product sharded over ``group``; backward:
    the ranks' partial input gradients summed."""
    return x if _trivial(group) else _CopyToShards.apply(x, group)


def reduce_from_shards(x: torch.Tensor, group: Optional[Group]
                       ) -> torch.Tensor:
    """The sum of the ranks' partial products, replicated; backward: the
    gradient as it is."""
    return x if _trivial(group) else _ReduceFromShards.apply(x, group)
