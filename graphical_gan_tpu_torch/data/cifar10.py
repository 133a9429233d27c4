"""CIFAR-10 loader (``graphical_gan_tpu/data/cifar10.py``,
``tflib/cifar10.py``).

Reads the python pickle batches ``data_batch_1..5`` and ``test_batch`` of
``data_dir``; yields int32 flat images [B, 3072] (the raw CIFAR row, NCHW
plane order) and labels. Without the files, synthetic random pixels.
``get_reconstruction_data`` is the fixed seed-1234 test subset
(``tflib/cifar10.py:14-19``).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.data.common import generator_factory

TRAIN_FILES = ["data_batch_%d" % i for i in range(1, 6)]
TEST_FILES = ["test_batch"]


def _unpickle(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return d["data"], d["labels"]


def _concat(filenames, data_dir):
    xs, ys = [], []
    for fn in filenames:
        x, y = _unpickle(os.path.join(data_dir, fn))
        xs.append(x)
        ys.append(y)
    return (np.concatenate(xs, axis=0).astype(np.int32),
            np.concatenate([np.asarray(y) for y in ys], axis=0))


def have_files(data_dir: Optional[str]) -> bool:
    return bool(data_dir) and all(
        os.path.isfile(os.path.join(data_dir, f))
        for f in TRAIN_FILES + TEST_FILES)


def get_reconstruction_data(n_samples: int, data_dir: Optional[str] = None):
    """The first ``n_samples`` of the test set shuffled by
    ``RandomState(1234)`` (``tflib/cifar10.py:14-19``); without the files,
    of ``images_int(10000, 3072, seed=99)``."""
    if have_files(data_dir):
        data, _ = _unpickle(os.path.join(data_dir, "test_batch"))
        data = np.asarray(data)
    else:
        data = synthetic.images_int(10000, 3072, seed=99)
    rng = np.random.RandomState(1234)
    data = data.copy()
    rng.shuffle(data)
    return data[:n_samples]


def load(batch_size: int, data_dir: Optional[str] = None,
         synthetic_fallback: bool = True,
         synthetic_sizes=(50000, 10000), seed: Optional[int] = None):
    """(train, test) factories; ``seed`` seeds each split's epoch order."""
    if have_files(data_dir):
        train = _concat(TRAIN_FILES, data_dir)
        test = _concat(TEST_FILES, data_dir)
    else:
        if not synthetic_fallback:
            raise FileNotFoundError(str(data_dir))
        train = (synthetic.images_int(synthetic_sizes[0], 3072, 0),
                 synthetic.labels(synthetic_sizes[0], 10))
        test = (synthetic.images_int(synthetic_sizes[1], 3072, 1),
                synthetic.labels(synthetic_sizes[1], 10))
    return (generator_factory(batch_size, *train, seed=seed),
            generator_factory(batch_size, *test, seed=seed))
