"""Latent-space scatter plots (``graphical_gan_tpu/report/
visualization.py``, ``tflib/visualization.py``).

A class-colored scatter of 2-D (TSNE'd) latents, with an optional plot of
the mixture means; matplotlib and sklearn are imported where they run (the
card's machine has neither; the TSNE hook skips there).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def scatter(data: np.ndarray, label: np.ndarray, dir: str, file_name: str,
            mus: Optional[np.ndarray] = None, mark_size: float = 2.0) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    label = np.asarray(label)
    if label.ndim == 2:
        label = np.argmax(label, axis=1)

    plt.clf()
    fig, ax = plt.subplots(figsize=(6, 6))
    for c in np.unique(label):
        m = label == c
        ax.scatter(data[m, 0], data[m, 1], s=mark_size, label=str(c))
    ax.legend(markerscale=4, fontsize=7)
    path = os.path.join(dir, file_name)
    fig.savefig(path)
    plt.close(fig)

    if mus is not None:
        fig, ax = plt.subplots(figsize=(6, 6))
        for c in range(mus.shape[0]):
            ax.scatter(mus[c, 0], mus[c, 1], s=mark_size * 20, label=str(c))
        fig.savefig(os.path.join(dir, "mus_" + file_name))
        plt.close(fig)
    return path


def tsne_2d(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """TSNE to 2-D (the reference uses sklearn's default TSNE)."""
    from sklearn.manifold import TSNE
    return TSNE(n_components=2, random_state=seed).fit_transform(
        np.asarray(x))
