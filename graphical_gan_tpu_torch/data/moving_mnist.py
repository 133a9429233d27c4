"""Moving-MNIST videos (``graphical_gan_tpu/data/moving_mnist.py``,
``tflib/simple_moving_mnist.py``).

The trajectory law of the reference (``:9-48``): a uniform start in
[0, 1]^2, a uniform angle, constant speed 0.1 per step, clamp-and-reflect at
the walls, the position recorded AFTER the first step; each 28x28 digit is
pasted on an empty 64x64 canvas at the integer-quantized position (one
digit per canvas, so a plain store is the reference's max-overlap,
``:50-52``). Videos are synthesized per batch: ``[B, LEN, 4096]`` float32
in [0, 1].

The JAX package has two random streams for the same law, and the stream is
the data, so the port has both and chooses with ``stream``:

- ``"native"`` (the default, as JAX's ``use_native=True``): each batch
  draws a seed ``RandomState.randint(0, 2**31)`` and each video its own
  SplitMix64 stream from (seed, index), as ``graphical_gan_tpu/native/
  moving_mnist.cc`` does. The port computes that stream in numpy: the
  uint64 mixer wraps as C's does, the uniforms are ``(z >> 11) * 2^-53``
  exactly, sin and cos are the C library's (``math.sin``/``math.cos``,
  one call per video), and the steps are the same IEEE double operations,
  unfused, as the C++ compiles them; so it gives the C++'s floats with no
  compiler, no build step to fail and no build cache to race on.
- ``"numpy"`` (JAX's ``use_native=False``): the trajectories come from the
  epoch's ``numpy.random.RandomState`` itself (``synthesize_batch``).

Where JAX's native build fails, its generator has drawn the batch seed
already and falls back to the numpy trajectories: a third stream, which
the port does not reproduce.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

IMAGE_SIZE = 64
DIGIT_SIZE = 28
STEP_LENGTH = 0.1
STREAMS = ("native", "numpy")

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _reflect(pos: np.ndarray, vel: np.ndarray):
    """Clamp at 0 and 1 and flip the velocity there (``:27-38``)."""
    over = pos >= 1.0
    under = pos <= 0.0
    pos = np.where(under, 0.0, np.where(over, 1.0, pos))
    return pos, np.where(under | over, -vel, vel)


def _walk(y, x, v_y, v_x, seq_length: int, image_size: int,
          digit_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(top, left) int32 [L, n] of the stepped and reflected positions."""
    canvas = image_size - digit_size
    tops = np.zeros((seq_length, y.shape[0]))
    lefts = np.zeros((seq_length, y.shape[0]))
    for i in range(seq_length):
        y = y + v_y * STEP_LENGTH
        x = x + v_x * STEP_LENGTH
        x, v_x = _reflect(x, v_x)
        y, v_y = _reflect(y, v_y)
        tops[i] = y
        lefts[i] = x
    return ((canvas * tops).astype(np.int32),
            (canvas * lefts).astype(np.int32))


def random_trajectory(rng: np.random.RandomState, n: int, seq_length: int,
                      image_size: int = IMAGE_SIZE,
                      digit_size: int = DIGIT_SIZE
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy stream's trajectories: (top, left) int32 [L, n]."""
    y = rng.rand(n)
    x = rng.rand(n)
    theta = rng.rand(n) * 2 * np.pi
    return _walk(y, x, np.sin(theta), np.cos(theta), seq_length,
                 image_size, digit_size)


def splitmix_uniforms(seed: int, n: int, count: int) -> np.ndarray:
    """[n, count] doubles in [0, 1): video i's first ``count`` uniforms of
    the SplitMix64 stream seeded ``seed * 0x9E3779B97F4A7C15 + i + 1``
    (``moving_mnist.cc: SplitMix64``), all arithmetic modulo 2^64."""
    with np.errstate(over="ignore"):
        state = (np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _GOLDEN
                 + np.arange(n, dtype=np.uint64) + np.uint64(1))
        out = np.empty((n, count), np.float64)
        for j in range(count):
            state = state + _GOLDEN
            z = state
            z = (z ^ (z >> np.uint64(30))) * _MIX1
            z = (z ^ (z >> np.uint64(27))) * _MIX2
            z = z ^ (z >> np.uint64(31))
            out[:, j] = (z >> np.uint64(11)).astype(np.float64) * 2.0 ** -53
    return out


def native_trajectory(seed: int, n: int, seq_length: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The native stream's trajectories: (top, left) int32 [L, n]."""
    u = splitmix_uniforms(seed, n, 3)
    # kTwoPi is 2·pi rounded to a double, as 2 * np.pi is
    theta = u[:, 2] * (2 * np.pi)
    v_y = np.array([math.sin(t) for t in theta])
    v_x = np.array([math.cos(t) for t in theta])
    return _walk(u[:, 0], u[:, 1], v_y, v_x, seq_length, IMAGE_SIZE,
                 DIGIT_SIZE)


def paste(digits: np.ndarray, top: np.ndarray, left: np.ndarray
          ) -> np.ndarray:
    """digits [B, 28, 28] placed at (top, left) [L, B] on empty canvases:
    [B, L, 64*64] float32."""
    b = digits.shape[0]
    seq_length = top.shape[0]
    data = np.zeros((b, seq_length, IMAGE_SIZE, IMAGE_SIZE), np.float32)
    rr = np.arange(DIGIT_SIZE)
    rows = top[:, :, None] + rr[None, None, :]            # [L, B, 28]
    cols = left[:, :, None] + rr[None, None, :]
    shape = (seq_length, b, DIGIT_SIZE, DIGIT_SIZE)
    b_idx = np.broadcast_to(np.arange(b)[None, :, None, None], shape)
    l_idx = np.broadcast_to(np.arange(seq_length)[:, None, None, None],
                            shape)
    data[b_idx, l_idx, np.broadcast_to(rows[:, :, :, None], shape),
         np.broadcast_to(cols[:, :, None, :], shape)] = digits[None]
    return data.reshape(b, seq_length, IMAGE_SIZE * IMAGE_SIZE)


def synthesize_batch(rng: np.random.RandomState, digits: np.ndarray,
                     seq_length: int) -> np.ndarray:
    """The numpy stream: digits [B, 28, 28] in [0, 1] -> [B, L, 4096]."""
    top, left = random_trajectory(rng, digits.shape[0], seq_length)
    return paste(digits, top, left)


def synthesize_batch_native(digits: np.ndarray, seq_length: int,
                            seed: int) -> np.ndarray:
    """The native stream (``native/moving_mnist.cc: synthesize_moving_
    mnist``): digits [B, 28, 28] -> [B, L, 4096]."""
    digits = np.asarray(digits, np.float32)
    top, left = native_trajectory(seed, digits.shape[0], seq_length)
    return paste(digits, top, left)


def _video_generator(images: np.ndarray, labels: np.ndarray,
                     seq_length: int, batch_size: int,
                     seed: Optional[int] = None, stream: str = "native"):
    """An epoch-generator factory of ``(videos [B, L, 4096], labels [B])``:
    each epoch a ``RandomState(seed)`` permutation of the digits, the
    partial last batch dropped."""
    if stream not in STREAMS:
        raise ValueError(f"stream {stream!r}: one of {STREAMS}")
    images = images.reshape(-1, DIGIT_SIZE, DIGIT_SIZE).astype(np.float32)
    rng = np.random.RandomState(seed)

    def get_epoch():
        perm = rng.permutation(len(images))
        for i in range(len(images) // batch_size):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            if stream == "native":
                batch = synthesize_batch_native(
                    images[idx], seq_length, int(rng.randint(0, 2 ** 31)))
            else:
                batch = synthesize_batch(rng, images[idx], seq_length)
            yield batch, labels[idx]

    return get_epoch


def _collect(factory):
    xs, ys = [], []
    for x, y in factory():
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs, 0), np.concatenate(ys, 0)


def _mnist_pool(cla: Optional[int], data_dir: Optional[str] = None,
                seed: Optional[int] = 0):
    """((train digits, labels), (test digits, labels)): MNIST's train and
    dev splits pooled, and its test split (``mnist.load``'s sources in
    ``data_dir``, else its synthetic fallback), optionally one class."""
    from graphical_gan_tpu_torch.data import mnist
    path = os.path.join(data_dir, mnist.FILENAME) if data_dir else None
    train_f, dev_f, test_f = mnist.load(50, 50, path=path, seed=seed)
    tr, dv, te = _collect(train_f), _collect(dev_f), _collect(test_f)
    train_x = np.concatenate([tr[0], dv[0]], axis=0)
    train_y = np.concatenate([tr[1], dv[1]], axis=0)
    test_x, test_y = te
    if cla is not None:
        keep = train_y == cla
        train_x, train_y = train_x[keep], train_y[keep]
        keep = test_y == cla
        test_x, test_y = test_x[keep], test_y[keep]
    return (train_x, train_y), (test_x, test_y)


def load_video(seq_length: int, batch_size: int, cla: Optional[int] = None,
               data_dir: Optional[str] = None, stream: str = "native"):
    """``simple_moving_mnist.py:93-113``: (train, test) video generators,
    epochs seeded 0 and 1."""
    (train_x, train_y), (test_x, test_y) = _mnist_pool(cla, data_dir)
    return (_video_generator(train_x, train_y, seq_length, batch_size, 0,
                             stream),
            _video_generator(test_x, test_y, seq_length, batch_size, 1,
                             stream))


def load_image(seq_length: int, batch_size: int, cla: Optional[int] = None,
               data_dir: Optional[str] = None, stream: str = "native"):
    """``simple_moving_mnist.py:115-153``: the videos' frames flattened to
    ``(frames [batch_size, 4096], labels [batch_size])``, each video's
    label repeated per frame."""
    if batch_size % seq_length:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"seq_length {seq_length}")
    (train_x, train_y), (test_x, test_y) = _mnist_pool(cla, data_dir)

    def make(images, labels, seed):
        vid = _video_generator(images, labels, seq_length,
                               batch_size // seq_length, seed, stream)

        def get_epoch():
            for v, y in vid():
                frames = v.reshape(batch_size, IMAGE_SIZE * IMAGE_SIZE)
                lab = np.tile(y.reshape(-1, 1), (1, seq_length)).reshape(-1)
                yield frames, lab

        return get_epoch

    return make(train_x, train_y, 0), make(test_x, test_y, 1)
