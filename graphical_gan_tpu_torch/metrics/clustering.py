"""Unsupervised clustering accuracy (``graphical_gan_tpu/metrics/
clustering.py``, the GMGAN eval of ``gmgan_inference_mnist.py:513-531``),
numpy only, the port's own copy: each cluster k is labeled by the class of
the example with the highest q(k|x), the label spreads to the cluster's
members, and the accuracy is the share of matches."""

from __future__ import annotations

import numpy as np


def clustering_accuracy(prob_c: np.ndarray, y: np.ndarray) -> float:
    """prob_c: [N, K] posterior cluster probabilities; y: [N] labels."""
    prob_c = np.asarray(prob_c)
    y = np.asarray(y)
    ind_max_prob = np.argmax(prob_c, axis=0)         # [K] best example per k
    labels_for_clusters = y[ind_max_prob]            # [K]
    clusters = np.argmax(prob_c, axis=1)             # [N]
    predicted = labels_for_clusters[clusters]
    return float(np.mean((predicted == y).astype(np.float32)))
