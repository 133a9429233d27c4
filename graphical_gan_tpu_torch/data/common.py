"""Shared loader utilities (``graphical_gan_tpu/data/common.py``).

A loader's ``load(...)`` returns epoch-generator factories: each a zero-arg
callable returning a fresh iterator of numpy batches (``tflib/mnist.py:
49-64``). Shuffling is the reference's paired shuffle (one RNG state reused
across arrays). One seed gives the same rows here as in the JAX package:
the same ``RandomState`` calls, and the same gather. There is no
``maybe_download``: where a JAX loader would try a URL, the port's goes on
to its next local source, then to its synthetic fallback.

:func:`take_rows` is the batches' row gather (JAX ``native/batcher.cc``
and ``batcher_ext.py``): exactly ``a[idx]`` over the first axis, large
gathers split over threads (:func:`gather_rows_threaded`: a
``torch.index_select`` per thread over zero-copy byte views of the array
and of the output, which runs without the GIL, so no native build).
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional

import numpy as np

#: below this many output bytes the gather is serial: numpy's is then
#: memory-bound and threads cost more than they save (JAX
#: ``native/batcher_ext.py``'s crossover, ~1 MiB)
NATIVE_MIN_BYTES = 1 << 20


def _n_threads() -> int:
    env = os.environ.get("GGAN_BATCHER_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, (os.cpu_count() or 1) - 1))


def gather_rows_threaded(a: np.ndarray, idx,
                         n_threads: Optional[int] = None
                         ) -> Optional[np.ndarray]:
    """``a[idx]`` over the first axis on ``n_threads`` threads (default
    ``GGAN_BATCHER_THREADS`` or the cores less one, at most 8), or None
    where ``a`` is no C-contiguous array of a fixed-size dtype or ``idx``
    is not 1-D. Any dtype: the rows are moved as bytes. An in-range
    negative index wraps, an out-of-range one raises ``IndexError``
    (JAX's ``gather_rows_native``)."""
    if not (isinstance(a, np.ndarray) and a.flags.c_contiguous
            and a.ndim >= 1 and a.dtype != object):
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        return None
    n = a.shape[0]
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError("gather_rows_threaded: index out of range")
        if lo < 0:
            idx = np.where(idx < 0, idx + n, idx)
    out = np.empty((idx.size,) + a.shape[1:], dtype=a.dtype)
    row_bytes = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    if out.size == 0 or row_bytes == 0:
        return out
    import torch
    # the rows as words of the widest size that divides them
    word = next(w for w in (np.int64, np.int32, np.int16, np.uint8)
                if row_bytes % np.dtype(w).itemsize == 0)
    src = torch.from_numpy(a.reshape(n, -1).view(np.uint8).view(word))
    dst = torch.from_numpy(out.reshape(idx.size, -1).view(np.uint8)
                           .view(word))
    index = torch.from_numpy(idx)
    k = max(1, min(n_threads or _n_threads(), idx.size))
    bounds = np.linspace(0, idx.size, k + 1).astype(np.int64)

    def part(lo, hi):
        torch.index_select(src, 0, index[lo:hi], out=dst[lo:hi])

    threads = [threading.Thread(target=part, args=(int(lo), int(hi)))
               for lo, hi in zip(bounds[1:-1], bounds[2:])]
    for t in threads:
        t.start()
    part(int(bounds[0]), int(bounds[1]))
    for t in threads:
        t.join()
    return out


def take_rows(a, idx) -> np.ndarray:
    """``a[idx]`` over the first axis: threaded where the gather moves at
    least :data:`NATIVE_MIN_BYTES` and there are two threads or more to
    use, numpy's own gather otherwise (JAX ``take_rows``)."""
    if isinstance(a, np.ndarray) and a.dtype != object:
        n_bytes = (len(idx) * a.dtype.itemsize
                   * int(np.prod(a.shape[1:], dtype=np.int64)))
        if (n_bytes >= NATIVE_MIN_BYTES and a.flags.c_contiguous
                and _n_threads() >= 2):
            out = gather_rows_threaded(a, idx)
            if out is not None:
                return out
    return a[idx]


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
        out = tuple(take_rows(a, idx) for a in arrays)
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
