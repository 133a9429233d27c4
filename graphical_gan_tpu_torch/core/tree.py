"""Batches as trees: a tensor (or array), or a dict of them with one shared
leading layout (SSGAN's ``{'x': videos, 'y': labels}``). The step, the
trainer and the data paths go through these few functions, so one code
path serves both forms, as ``jax.tree`` does in the JAX package."""

from __future__ import annotations

from typing import Callable, List

import numpy as np


def tree_map(fn: Callable, tree):
    """``fn`` on each leaf; a dict keeps its keys."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def first_leaf(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


def index(tree, i):
    """Entry ``i`` of the leading axis of every leaf."""
    return tree_map(lambda v: v[i], tree)


def chunk(tree, n: int) -> List:
    """``n`` equal pieces along the leading axis, each a tree."""
    if not isinstance(tree, dict):
        return list(tree.chunk(n))
    parts = {k: v.chunk(n) for k, v in tree.items()}
    return [{k: p[j] for k, p in parts.items()} for j in range(n)]


def device(tree):
    """The device of the first leaf."""
    return first_leaf(tree).device


def stack(trees: List):
    """numpy stack of equally shaped host trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: np.stack([np.asarray(t[k]) for t in trees])
                for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def nbytes(tree) -> int:
    """Bytes of a host tree's leaves."""
    if isinstance(tree, dict):
        return sum(np.asarray(v).nbytes for v in tree.values())
    return np.asarray(tree).nbytes
