"""Each rank's slice of the global batch (``graphical_gan_tpu/parallel/
input.py``).

In JAX a host feeds its local rows and ``make_array_from_process_local_
data`` assembles the global array. In the port every rank is a process,
so each keeps the rows it computes on: :func:`host_local_batches` cuts a
rank's rows out of the global batch (resident data or a host loader's
batch, which every rank draws from the same seed), and
:func:`global_batch_sharding` says which rows those are.
"""

from __future__ import annotations

from typing import Tuple

from graphical_gan_tpu_torch.parallel.mesh import Mesh, shard_batch


def global_batch_sharding(mesh: Mesh, ndim: int, axis: str = "data",
                          batch_dim: int = 1) -> Tuple[int, int, int]:
    """(batch_dim, this rank's block index, blocks): the global batch's
    rows split in rank order over ``axis``."""
    g = mesh.group(axis)
    if batch_dim >= ndim:
        raise ValueError(f"batch dim {batch_dim} of a {ndim}-d leaf")
    return (batch_dim, 0 if g is None else g.index,
            1 if g is None else g.size)


def host_local_batches(mesh: Mesh, batch, axis: str = "data",
                       batch_dim: int = 1):
    """This rank's rows of the stacked global batch ``[(1+k), B, ...]``
    (a tensor, an array or a dict of them), on the rank's device."""
    return shard_batch(mesh, batch, axis, batch_dim)
