"""The rank's sharding context (``graphical_gan_tpu/core/shard_ctx.py``).

JAX's model code calls ``constrain_frames`` / ``constrain_components`` at
its fold points, and GSPMD places the sharding that the parallel step
installed (``frame_constraint`` / ``component_constraint``) there while
it traces. The port runs one process per rank, so the same points are
where a rank takes its block of a tensor every rank holds, or gathers the
blocks back, by the groups of the step's ``Sharding`` (installed with
``parallel/context.py: sharding``, which takes the place of JAX's two
installers); model and op code consult that thread-local context and
never import the parallel layer's step factories. With no context active (the default,
and every one-process run) every function here is the identity and the
ops run as they always did.

A ``Sharding`` (``parallel/context.py``, where model and op code read
it; installed by ``parallel/mesh.py: make_sharded_step``'s step for the
duration of one step, or by a test) names the groups of this rank
(``parallel/collectives.py: Group``):

- ``rows``: the ``data`` group. A draw of the model (``models/common.py:
  Draws``) is made at the global batch's rows from the one seed every rank
  shares, and the rank takes its own rows, as JAX draws full logical-batch
  arrays from a replicated key;
- ``stats``: the ranks whose rows are distinct and together make the
  batch (``data``, or ``data`` x ``seq`` under SP): batch-statistics BN
  sums over it (``ops/norm.py``), and the batch-coupled objectives gather
  their inputs over it (:func:`gather_batch`);
- ``seq``: SP's frame group: the frame networks run on the rank's block of
  the LEN frames of each video (:func:`constrain_frames`), and their
  outputs are gathered again (:func:`gather_frames`);
- ``model`` and ``tp``: TP's group and the parameters it holds in slices
  (name -> the sharded axis, ``parallel/sharding_rules.py``);
- ``expert``: EP's group; ``Generator.Hyper.Mu`` holds the rank's block of
  components (:func:`constrain_components` and the component reductions
  below).
"""

from __future__ import annotations

import torch

from graphical_gan_tpu_torch.parallel.context import group as _group


# -- the fold points --------------------------------------------------------------

def _frame_block(h: torch.Tensor, seq_len: int, gather: bool
                 ) -> torch.Tensor:
    from graphical_gan_tpu_torch.parallel import collectives as col
    g = _group("seq")
    if g is None:
        return h
    rest = tuple(h.shape[1:])
    if gather:
        v = h.reshape((-1, seq_len // g.size) + rest)
        return col.all_gather(v, g, dim=1).reshape((-1,) + rest)
    v = h.reshape((-1, seq_len) + rest)
    return col.shard_rows(v, g, dim=1).reshape((-1,) + rest)


def constrain_frames(h: torch.Tensor, seq_len: int) -> torch.Tensor:
    """A folded ``[B*LEN, ...]`` tensor every rank of the frame group holds
    -> the rank's ``[B*LEN/S, ...]`` block of frames (each video's
    consecutive LEN/S frames). Identity unless SP is active."""
    return _frame_block(h, seq_len, gather=False)


def gather_frames(h: torch.Tensor, seq_len: int) -> torch.Tensor:
    """The frame networks' ``[B*LEN/S, ...]`` outputs gathered back into
    ``[B*LEN, ...]`` in frame order; backward: each rank's frames get the
    group's summed gradient. Identity unless SP is active."""
    return _frame_block(h, seq_len, gather=True)


def constrain_components(h: torch.Tensor) -> torch.Tensor:
    """A ``[..., n_coms]`` tensor every rank holds -> the rank's block of
    components. Identity unless EP is active."""
    from graphical_gan_tpu_torch.parallel import collectives as col
    return col.slice_replicated(h, _group("expert"), dim=-1)


def gather_components(h: torch.Tensor) -> torch.Tensor:
    """The ranks' ``[..., n_coms/E]`` blocks as the whole ``[..., n_coms]``
    for the replicated program. Identity unless EP is active."""
    from graphical_gan_tpu_torch.parallel import collectives as col
    return col.gather_replicated(h, _group("expert"), dim=-1)


def to_components(z: torch.Tensor) -> torch.Tensor:
    """A replicated input of a computation over the rank's block of
    components (the posterior's distances to the rank's means): its
    gradient is the blocks' partial gradients summed. Identity unless EP
    is active."""
    from graphical_gan_tpu_torch.parallel import collectives as col
    return col.copy_to_shards(z, _group("expert"))


def sum_components(h: torch.Tensor) -> torch.Tensor:
    """A product over the sharded component axis: the ranks' partial sums
    added (``k @ Mu``). Identity unless EP is active."""
    from graphical_gan_tpu_torch.parallel import collectives as col
    return col.reduce_from_shards(h, _group("expert"))


def component_softmax(v: torch.Tensor) -> torch.Tensor:
    """Softmax over the component axis of the rank's block: the max and
    the sum of exponentials taken over the ranks."""
    g = _group("expert")
    if g is None:
        return torch.softmax(v, dim=-1)
    from graphical_gan_tpu_torch.parallel import collectives as col
    m = col.all_max(v.detach().amax(dim=-1, keepdim=True), g)
    e = torch.exp(v - m)
    # the replicated sum feeds each rank's block: its gradient is the
    # blocks' partial gradients summed
    total = col.reduce_from_shards(e.sum(dim=-1, keepdim=True), g)
    return e / col.copy_to_shards(total, g)


def component_argmax_one_hot(v: torch.Tensor, n_coms: int) -> torch.Tensor:
    """one_hot(argmax over all components) in the rank's block of
    columns, v's dtype; the first maximum wins, as ``argmax`` picks it."""
    g = _group("expert")
    if g is None:
        return torch.nn.functional.one_hot(
            v.argmax(dim=-1), n_coms).to(v.dtype)
    from graphical_gan_tpu_torch.parallel import collectives as col
    n_local = v.shape[-1]
    vals, idx = v.detach().max(dim=-1)
    all_vals = col.gather_stack(vals, g)
    all_idx = col.gather_stack(idx + g.index * n_local, g)
    pick = all_vals.argmax(dim=0, keepdim=True)  # the first rank at the max
    best = all_idx.gather(0, pick)[0]
    cols = torch.arange(n_local, device=v.device) + g.index * n_local
    return (cols == best[..., None]).to(v.dtype)


# -- the batch group -----------------------------------------------------------

def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """x's rows gathered over the batch group, for an objective that
    couples every row of the batch (each rank then computes it whole;
    backward: each rank's rows get the group's summed gradient)."""
    from graphical_gan_tpu_torch.parallel import collectives as col
    return col.all_gather(x, _group("rows"), dim=0)
