"""Synthetic datasets of the right shapes and dtypes, numpy only
(``graphical_gan_tpu/data/synthetic.py``): the same seeds give the same
arrays as the JAX package's."""

from __future__ import annotations

import numpy as np


def images_unit(n: int, output_dim: int, seed: int = 0) -> np.ndarray:
    """float32 in [0,1]: mnist-like flat images."""
    return np.random.RandomState(seed).rand(n, output_dim).astype("float32")


def images_int(n: int, output_dim: int, seed: int = 0) -> np.ndarray:
    """int32 pixel values in [0,255]: cifar/svhn-like flat images."""
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, output_dim)).astype("int32")


def labels(n: int, n_classes: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, n_classes, size=(n,)).astype("int64")


def videos_unit(n: int, seq_len: int, output_dim: int, seed: int = 0
                ) -> np.ndarray:
    """float32 in [0,1]: [n, seq_len, output_dim] flat frames."""
    return np.random.RandomState(seed).rand(
        n, seq_len, output_dim).astype("float32")


def structured_images_labeled(n: int, image_hw=(32, 32), channels: int = 3,
                              n_classes: int = 10, seed: int = 0):
    """A learnable K-class image family: class k is a 2-D sinusoid whose
    frequency and orientation k sets, mixed per sample with a random phase,
    amplitude and smooth gradient field, plus pixel noise.

    Returns ``(images_int32[N, H*W*C] in [0,255] flat NCHW order,
    labels_int64[N])``.
    """
    rng = np.random.RandomState(seed)
    h, w = image_hw
    labels_ = rng.randint(0, n_classes, size=n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = yy / h, xx / w
    angles = np.pi * np.arange(n_classes) / n_classes
    freqs = 2.0 + 1.5 * (np.arange(n_classes) % 4)
    imgs = np.empty((n, channels, h, w), np.float64)
    for i in range(n):
        k = labels_[i]
        phase = rng.rand() * 2 * np.pi
        amp = 0.6 + 0.4 * rng.rand()
        proj = np.cos(angles[k]) * xx + np.sin(angles[k]) * yy
        pattern = amp * np.sin(2 * np.pi * freqs[k] * proj + phase)
        a, b = rng.rand(2)
        base = pattern + 0.5 * (a * yy + b * xx)
        for c in range(channels):
            # the channels carry the same structure at shifted phase
            shift = 0.35 * c
            imgs[i, c] = base + shift * np.sin(
                2 * np.pi * freqs[k] * proj + phase + shift)
    imgs += rng.randn(n, channels, h, w) * 0.08
    lo = imgs.min(axis=(1, 2, 3), keepdims=True)
    hi = imgs.max(axis=(1, 2, 3), keepdims=True)
    imgs = (imgs - lo) / np.maximum(hi - lo, 1e-9)
    flat = (imgs * 255.0).round().astype(np.int32).reshape(n, -1)
    return flat, labels_.astype(np.int64)
