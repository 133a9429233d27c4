"""CelebA loader (``graphical_gan_tpu/data/celeba.py``, ``tflib/
celebA.py``).

Loads a pre-built ``celebA_64x64.npy`` (NCHW uint8) from ``data_dir``,
shuffles it with ``RandomState(0)`` and splits off the first ``num_dev``
as the dev set (``tflib/celebA.py:21-35``); yields flat int [B, 12288]
batches (images only). Without the file, synthetic random pixels. The
offline converter (``center_crop``, ``convert_to_numpy``: 202,599 jpgs
center-cropped to 64x64, ``:43-73``) needs PIL, imported where it runs.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.data.common import generator_factory

FILENAME = "celebA_64x64.npy"


def load(batch_size: int, data_dir: Optional[str] = None,
         num_dev: int = 5000, synthetic_fallback: bool = True,
         synthetic_size: int = 202599, seed: Optional[int] = None):
    """(train, dev) factories; ``seed`` seeds each split's epoch order."""
    path = os.path.join(data_dir or "", FILENAME)
    if data_dir and os.path.isfile(path):
        data = np.load(path)
        data = data.reshape(data.shape[0], -1)
    else:
        if not synthetic_fallback:
            raise FileNotFoundError(path)
        data = synthetic.images_int(min(synthetic_size, 20000), 64 * 64 * 3, 7)
    data = data.copy()
    np.random.RandomState(0).shuffle(data)
    x_train = data[num_dev:]
    x_test = data[:num_dev]
    return (generator_factory(batch_size, x_train, seed=seed),
            generator_factory(batch_size, x_test, seed=seed))


def center_crop(x: np.ndarray, resize_h: int = 64, resize_w: int = 64
                ) -> np.ndarray:
    """``tflib/celebA.py:47-53``: width-preserving resize, then a vertical
    center crop."""
    from PIL import Image
    h, w = x.shape[:2]
    if h < w:
        raise ValueError(f"center_crop takes portrait images, got {h}x{w}")
    new_h = int(h * resize_w / w)
    img = Image.fromarray(x.astype(np.uint8)).resize((resize_w, new_h))
    x = np.asarray(img)
    margin = int(round((new_h - resize_h) / 2))
    return x[margin:margin + resize_h]


def convert_to_numpy(data_path: str, out_path: str = FILENAME,
                     size: int = 64, limit: int = 202599) -> str:
    """Offline jpg -> npy converter (``tflib/celebA.py:61-73``)."""
    from PIL import Image
    files = sorted(glob(os.path.join(data_path, "*.jpg")))[:limit]
    samples = []
    for f in files:
        img = np.asarray(Image.open(f).convert("RGB"), dtype=np.float64)
        samples.append(center_crop(img, size, size))
    arr = np.asarray(samples)
    arr = np.transpose(arr, (0, 3, 1, 2))  # NCHW like the reference
    np.save(out_path, arr)
    return out_path
