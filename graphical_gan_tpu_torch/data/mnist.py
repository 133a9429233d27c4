"""MNIST loader (``graphical_gan_tpu/data/mnist.py``, ``tflib/mnist.py``).

``load(batch_size, test_batch_size)`` returns (train, dev, test) epoch-
generator factories of ``(images[B, 784] float32 in [0, 1], labels[B])``
with the reference's 50k/10k/10k splits.

Sources, in order: the gzip pickle at ``path`` (the reference's
``mnist.pkl.gz``), the four idx files beside it (assembled into the same
splits), then deterministic synthetic data (with a warning). Nothing is
downloaded, and with ``path=None`` the loader goes straight to the
synthetic data.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import sys
from typing import Optional, Tuple

import numpy as np

from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.data.common import generator_factory

FILENAME = "mnist.pkl.gz"
IDX_FILES = {
    "train_x": "train-images-idx3-ubyte.gz",
    "train_y": "train-labels-idx1-ubyte.gz",
    "test_x": "t10k-images-idx3-ubyte.gz",
    "test_y": "t10k-labels-idx1-ubyte.gz",
}


def _load_pickle(path: str):
    with gzip.open(path, "rb") as f:
        # the original file is a Python 2 pickle
        return pickle.load(f, encoding="latin1")


def _read_idx(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _load_idx_dir(dirpath: str):
    """The reference's (train, dev, test) 50k/10k/10k splits from the four
    idx files."""
    tx = _read_idx(os.path.join(dirpath, IDX_FILES["train_x"]))
    ty = _read_idx(os.path.join(dirpath, IDX_FILES["train_y"]))
    ex = _read_idx(os.path.join(dirpath, IDX_FILES["test_x"]))
    ey = _read_idx(os.path.join(dirpath, IDX_FILES["test_y"]))
    tx = (tx.reshape(-1, 784).astype(np.float32)) / 255.0
    ex = (ex.reshape(-1, 784).astype(np.float32)) / 255.0
    return ((tx[:50000], ty[:50000].astype(np.int64)),
            (tx[50000:], ty[50000:].astype(np.int64)),
            (ex, ey.astype(np.int64)))


def _try_idx_dir(dirpath: str):
    if not all(os.path.isfile(os.path.join(dirpath, fn))
               for fn in IDX_FILES.values()):
        return None
    try:
        return _load_idx_dir(dirpath)
    except (OSError, ValueError, struct.error):
        return None


def _synthetic_split(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    return (synthetic.images_unit(n, 784, seed=seed),
            synthetic.labels(n, 10, seed=seed + 1))


def load(batch_size: int, test_batch_size: int,
         n_labelled: Optional[int] = None, path: Optional[str] = None,
         synthetic_fallback: bool = True,
         synthetic_sizes: Tuple[int, int, int] = (50000, 10000, 10000),
         seed: Optional[int] = None):
    """``seed`` seeds each split's epoch order (the JAX loader leaves it
    unseeded)."""
    data = None
    if path is not None and os.path.isfile(path):
        try:
            data = _load_pickle(path)
        except (OSError, EOFError, ValueError, pickle.UnpicklingError):
            data = None
    if data is None and path is not None:
        data = _try_idx_dir(os.path.dirname(os.path.abspath(path)))
    if data is None:
        if not synthetic_fallback:
            raise FileNotFoundError(path)
        print("WARNING: no MNIST files (mnist.pkl.gz or the idx files) "
              "were found: using SYNTHETIC random data, meaningless for "
              "sample quality.", file=sys.stderr)
        data = tuple(_synthetic_split(n, i)
                     for i, n in enumerate(synthetic_sizes))

    (train_x, train_y), (dev_x, dev_y), (test_x, test_y) = data
    train_x = np.ascontiguousarray(train_x, dtype=np.float32)
    dev_x = np.ascontiguousarray(dev_x, dtype=np.float32)
    test_x = np.ascontiguousarray(test_x, dtype=np.float32)

    def make(x, y, bs):
        if n_labelled is None:
            return generator_factory(bs, x, np.asarray(y), seed=seed)
        # semi-supervised mask: n_labelled examples flagged 1, shuffled with
        # the data each epoch (``tflib/mnist.py:17-20,27-29``). The
        # reference yields the full (unbatched) mask with every batch, an
        # apparent bug; this yields the batch's slice of it, as JAX does.
        labelled = np.zeros(len(x), dtype=np.int32)
        labelled[:n_labelled] = 1
        return generator_factory(bs, x, np.asarray(y), labelled, seed=seed)

    return (
        make(train_x, train_y, batch_size),
        make(dev_x, dev_y, test_batch_size),
        make(test_x, test_y, test_batch_size),
    )
