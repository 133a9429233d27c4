"""Frechet distance between feature distributions (FID), numpy and scipy
only: a copy of ``graphical_gan_tpu/metrics/fid.py``, so that the port
imports nothing of the JAX package.

FID = ||mu_a - mu_b||^2 + Tr(S_a + S_b - 2 (S_a S_b)^(1/2)), over the
features of any extractor: here the port's ``MetricClassifier``'s pooled
penultimate features (``metrics/classifier.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    f = np.asarray(features, dtype=np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians: scipy's ``sqrtm``, retried with ``eps``
    added to both diagonals when the root is non-finite or has an imaginary
    part above 1e-3 of its real scale; refuses a root whose imaginary part
    stays above 1e-2 of it, or that stays non-finite."""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))

    def _sqrtm(m):
        out = linalg.sqrtm(m)  # scipy >= 1.17 returns just the matrix
        return out[0] if isinstance(out, tuple) else out

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    bad = (not np.isfinite(covmean).all()) or (
        np.iscomplexobj(covmean)
        and np.abs(covmean.imag).max() > 1e-3 * max(1.0,
                                                    np.abs(covmean.real).max()))
    if bad:
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        rel_imag = np.abs(covmean.imag).max() / max(
            1.0, np.abs(covmean.real).max())
        if rel_imag > 1e-2:
            raise ValueError(
                f"sqrtm produced a substantially complex result "
                f"(rel imag {rel_imag:.3g}); covariances are too "
                f"ill-conditioned for a trustworthy FID: use more samples "
                f"or lower-dimensional features")
        covmean = covmean.real
    if not np.isfinite(covmean).all():
        raise ValueError(
            "covariance sqrtm is non-finite (NaN/Inf features?); refusing "
            "to return a garbage FID")
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = gaussian_stats(feats_a)
    mu2, s2 = gaussian_stats(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


def compute_fid(images_a, images_b,
                feature_fn: Callable[[np.ndarray], np.ndarray],
                batch_size: int = 100) -> float:
    """images: [N, H, W, C] arrays in the uint8 range; ``feature_fn`` maps a
    batch to [B, D] features.

    Caveat for feature extractors with batch-statistics BN (the
    ``MetricClassifier``): features depend on the batch's composition, so
    FIDs compare only at the same ``batch_size`` with full batches (N a
    multiple of it)."""

    def feats(images):
        out = []
        images = np.asarray(images)
        for i in range(0, len(images), batch_size):
            out.append(np.asarray(feature_fn(images[i:i + batch_size])))
        return np.concatenate(out, axis=0)

    return fid_from_features(feats(images_a), feats(images_b))
