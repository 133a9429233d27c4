"""SVHN loader (``graphical_gan_tpu/data/svhn.py``, ``tflib/svhn.py``).

Reads ``train_32x32.mat`` and ``test_32x32.mat`` of ``data_dir`` through
``scipy.io.loadmat``: HWCN -> NCHW -> flat int32 [B, 3072], label 10 -> 0
(``tflib/svhn.py:36-45``). Without both files, synthetic random pixels;
nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.data.common import generator_factory

TRAIN_FILE = "train_32x32.mat"
TEST_FILE = "test_32x32.mat"


def _load_mat(path: str):
    from scipy.io import loadmat
    d = loadmat(path)
    x = d["X"]                      # HWCN
    y = d["y"].flatten()
    y[y == 10] = 0
    x = np.transpose(x, (3, 2, 0, 1)).reshape(-1, 32 * 32 * 3)
    return x.astype(np.int32), y.astype(np.int64)


def load(batch_size: int, data_dir: Optional[str] = None,
         synthetic_fallback: bool = True, synthetic_sizes=(73257, 26032),
         seed: Optional[int] = None):
    """(train, test) factories; ``seed`` seeds each split's epoch order."""
    train_p = os.path.join(data_dir or "", TRAIN_FILE)
    test_p = os.path.join(data_dir or "", TEST_FILE)
    if data_dir and os.path.isfile(train_p) and os.path.isfile(test_p):
        train = _load_mat(train_p)
        test = _load_mat(test_p)
    else:
        if not synthetic_fallback:
            raise FileNotFoundError(str(data_dir))
        train = (synthetic.images_int(synthetic_sizes[0], 3072, 0),
                 synthetic.labels(synthetic_sizes[0], 10))
        test = (synthetic.images_int(synthetic_sizes[1], 3072, 1),
                synthetic.labels(synthetic_sizes[1], 10))
    return (generator_factory(batch_size, *train, seed=seed),
            generator_factory(batch_size, *test, seed=seed))
