"""This rank's parallel context: which of its process groups a step's
ops and models reduce over (``core/shard_ctx.py`` is its face for model
code; the ops layer reads it here, importing nothing but torch).

A :class:`Sharding` is installed for the duration of one step by
``parallel/mesh.py: make_sharded_step``'s step (or by a test); with none
installed, every lookup gives None and the ops run as in one process.
Its fields are ``parallel/collectives.py: Group``s or None:

- ``rows``: the ``data`` group, whose ranks hold the batch's rows in
  blocks (the models' draws are made at the global batch and cut);
- ``stats``: the ranks whose rows together make the batch (``data``, or
  ``data`` x ``seq`` under SP): batch statistics and the gradient mean
  run over it;
- ``seq``: SP's frame group;
- ``model`` with ``tp`` (parameter name -> the dim TP holds in slices);
- ``expert``: EP's group.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

_local = threading.local()


@dataclass
class Sharding:
    rows: Optional[object] = None
    stats: Optional[object] = None
    seq: Optional[object] = None
    model: Optional[object] = None
    tp: Dict[str, int] = field(default_factory=dict)
    expert: Optional[object] = None


def current() -> Optional[Sharding]:
    return getattr(_local, "sharding", None)


@contextlib.contextmanager
def sharding(s: Optional[Sharding]):
    """Install ``s`` as this thread's context for the block."""
    prev = current()
    _local.sharding = s
    try:
        yield s
    finally:
        _local.sharding = prev


def group(attr: str):
    """The context's group ``attr``, or None (no context, none set, or a
    group of one rank)."""
    s = current()
    g = None if s is None else getattr(s, attr)
    return None if g is None or g.size == 1 else g


def rows_group():
    """The ``data`` group of the draws, or None."""
    return group("rows")


def stats_group():
    """The group batch statistics sum over, or None."""
    return group("stats")


def model_shard(name: str):
    """(group, dim) where TP holds parameter ``name`` in slices, else
    None."""
    g = group("model")
    if g is None or name not in current().tp:
        return None
    return g, current().tp[name]
