"""3D-chairs videos (``graphical_gan_tpu/data/chairs.py``,
``tflib/chairs.py``).

``load`` reads ``chairs_{size}.npy`` (N chairs x 31 azimuth frames x size
x size x 3 int pixels, the layout JAX's ``convert_to_numpy`` writes) from
``data_dir``, or falls back to synthetic int pixels (``RandomState(3)``,
``synthetic_size`` chairs; the JAX default of 1,000 is 1.5 GB of f32 on the
host, so tests pass a small one). ``chairs_64.npy`` is not in the
repository; the render-png converter waits until the renders are on a
machine that trains on them. The chairs are shuffled by
``RandomState(0)``, the first ``num_dev`` are the dev split, and each
split's epochs are seeded (train 1, dev 2). ``seq_length`` picks the clip
(``tflib/chairs.py:15-34``): 1 (flat frames), 4 (a random window per
chair and epoch), 31 (the whole turn) or a prefix. Batches are f32 raw
pixels [B, L, size*size*3] in NCHW order per frame ([B, size*size*3] for
seq_length 1); the model divides by 256.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _rand_clip(rng: np.random.RandomState, x: np.ndarray, seq_length: int):
    start = rng.randint(x.shape[0] - seq_length + 1)
    return x[start:start + seq_length]


def _chair_generator(batch_size, seq_length, data, size, seed=None):
    rng = np.random.RandomState(seed)

    def get_epoch():
        if seq_length == 1:
            data_all = data.reshape(-1, size * size * 3)
        elif seq_length == 31:
            data_all = data.reshape(-1, 31, size * size * 3)
        elif seq_length == 4:
            data_all = np.asarray([_rand_clip(rng, d, seq_length)
                                   for d in data])
        else:
            data_all = data[:, :seq_length, :]
        data_shuf = data_all.copy()
        rng.shuffle(data_shuf)
        for i in range(data_shuf.shape[0] // batch_size):
            yield data_shuf[i * batch_size:(i + 1) * batch_size]

    return get_epoch


def load(seq_length: int, batch_size: int, size: int = 64,
         data_dir: Optional[str] = None, num_dev: int = 200,
         synthetic_fallback: bool = True, synthetic_size: int = 1000):
    """(train, dev) epoch-generator factories."""
    path = os.path.join(data_dir or "", f"chairs_{size}.npy")
    if data_dir and os.path.isfile(path):
        data = np.load(path)
        data = np.transpose(data, (0, 1, 4, 2, 3))   # -> (N, 31, C, H, W)
        data = data.reshape(-1, 31, size * size * 3).astype(np.float32)
    else:
        if not synthetic_fallback:
            raise FileNotFoundError(path)
        # raw [0, 255] int pixels, normalized by /256 at the model boundary
        # (ssgan_inference_chairs.py:508)
        data = np.random.RandomState(3).randint(
            0, 256, size=(synthetic_size, 31, size * size * 3)
        ).astype(np.float32)
    data = data.copy()
    np.random.RandomState(0).shuffle(data)
    return (
        _chair_generator(batch_size, seq_length, data[num_dev:], size, 1),
        _chair_generator(batch_size, seq_length, data[:num_dev], size, 2),
    )


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """``tflib/chairs.py:61-64``: the fixed crop ``[140:460, 140:460]`` of a
    600x600 render, then PIL's bilinear resize to (size, size). PIL is
    imported here: only an offline render converter calls it."""
    from PIL import Image
    image = image[140:460, 140:460, :]
    img = Image.fromarray(image.astype(np.uint8)).resize(
        (size, size), Image.BILINEAR)
    return np.asarray(img)

