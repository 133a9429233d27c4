"""Shared loader utilities (``graphical_gan_tpu/data/common.py``), numpy
only.

A loader's ``load(...)`` returns epoch-generator factories: each a zero-arg
callable returning a fresh iterator of numpy batches (``tflib/mnist.py:
49-64``). Shuffling is the reference's paired shuffle (one RNG state reused
across arrays). One seed gives the same rows here as in the JAX package:
the same ``RandomState`` calls, and the gather is numpy's ``a[idx]`` (the
values of the JAX package's native gather). There is no ``maybe_download``:
where a JAX loader would try a URL, the port's goes on to its next local
source, then to its synthetic fallback.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def paired_shuffle(rng: np.random.RandomState, *arrays: np.ndarray) -> None:
    """In-place shuffle of several arrays with one permutation (the
    reference re-seeds the global RNG state, ``tflib/mnist.py:10-14``)."""
    state = rng.get_state()
    for a in arrays:
        rng.set_state(state)
        rng.shuffle(a)


def epoch_batches(batch_size: int, *arrays: np.ndarray,
                  rng: Optional[np.random.RandomState] = None,
                  drop_remainder: bool = True) -> Iterator:
    """One shuffled epoch of aligned batches over ``arrays``."""
    rng = rng or np.random.RandomState()
    n = len(arrays[0])
    perm = rng.permutation(n)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    for i in range(n_batches):
        idx = perm[i * batch_size:(i + 1) * batch_size]
        out = tuple(a[idx] for a in arrays)
        yield out if len(out) > 1 else out[0]


def generator_factory(batch_size: int, *arrays, seed: Optional[int] = None):
    """Epochs over ``arrays`` from one ``RandomState(seed)``: each call of
    the factory draws the next epoch's permutation."""
    rng = np.random.RandomState(seed)

    def get_epoch():
        return epoch_batches(batch_size, *arrays, rng=rng)

    return get_epoch


def materialize_epoch(factory, dtype=None):
    """One full epoch of a generator factory as one array: the first
    element of tuple batches (the images); dict batches concatenate per
    key. ``dtype`` casts each batch as it arrives (integer pixels to
    uint8), so the host never holds the epoch at a wider dtype."""
    xs = []
    for batch in factory():
        b = batch[0] if isinstance(batch, tuple) else batch
        if dtype is not None:
            if isinstance(b, dict):
                b = {k: np.asarray(v, dtype) for k, v in b.items()}
            else:
                b = np.asarray(b, dtype)
        xs.append(b)
    if isinstance(xs[0], dict):
        return {k: np.concatenate([b[k] for b in xs], axis=0)
                for k in xs[0]}
    return np.concatenate(xs, axis=0)
