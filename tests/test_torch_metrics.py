"""The port's quality metrics (graphical_gan_tpu_torch/metrics/{inception,
fid}.py) against the JAX package's: the split-KL inception score, the
batched classifier protocol, the IS hook's refusal of a frozen graph the
port cannot read yet, the feature Gaussian, the Frechet distance (its
epsilon retry and both refusals) and ``compute_fid``; results within
1e-12 relative (the same float64 arithmetic). The metric classifier is
``test_torch_metric_classifier.py``'s."""

import numpy as np
import pytest
import scipy.linalg

from graphical_gan_tpu.metrics import fid as jax_fid
from graphical_gan_tpu.metrics import inception as jax_inception
from graphical_gan_tpu_torch.metrics import fid, inception


def _probs(n, k=10, seed=0):
    p = np.random.default_rng(seed).random((n, k)) + 1e-3
    return p / p.sum(axis=1, keepdims=True)


# -- inception score ---------------------------------------------------------------

@pytest.mark.parametrize("n,splits", [(100, 10), (95, 10), (60, 3), (7, 1)])
def test_inception_score_from_probs_is_the_jax_score(n, splits):
    p = _probs(n, seed=n)
    got = inception.inception_score_from_probs(p, splits)
    want = jax_inception.inception_score_from_probs(p, splits)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("batch_size", [100, 32])
def test_get_inception_score_is_the_jax_protocol(batch_size):
    imgs = list(np.random.default_rng(1).random((250, 4, 4, 3)) * 255)
    w = np.random.default_rng(2).normal(size=(48, 10))

    def classifier(chunk):
        logits = chunk.reshape(len(chunk), -1) / 255.0 @ w
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    got = inception.get_inception_score(imgs, classifier,
                                        batch_size=batch_size)
    want = jax_inception.get_inception_score(imgs, classifier,
                                             batch_size=batch_size)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_get_inception_score_refuses_what_is_no_image_list():
    with pytest.raises(ValueError):
        inception.get_inception_score([], lambda x: x)
    with pytest.raises(ValueError):
        inception.get_inception_score([np.zeros((3, 3))], lambda x: x)


def test_default_is_classifier_refuses_a_frozen_graph(tmp_path, monkeypatch):
    pb = tmp_path / "graph.pb"
    pb.write_bytes(b"\0")
    monkeypatch.setenv("GGAN_INCEPTION_PB", str(pb))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        inception.default_is_classifier()


# -- FID -------------------------------------------------------------------------------

def _features(n=80, d=6, seed=3, rank=None):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, rank or d))
    if rank:
        f = f @ rng.normal(size=(rank, d))
    return f + rng.normal(size=d)


def test_gaussian_stats_are_the_jax_stats():
    f = _features()
    for got, want in zip(fid.gaussian_stats(f), jax_fid.gaussian_stats(f)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("rank", [None, 3], ids=["full", "rank3"])
def test_frechet_distance_is_the_jax_distance(rank):
    m1, s1 = fid.gaussian_stats(_features(rank=rank))
    m2, s2 = fid.gaussian_stats(_features(seed=4, rank=rank))
    got = fid.frechet_distance(m1, s1, m2, s2)
    assert got == pytest.approx(jax_fid.frechet_distance(m1, s1, m2, s2),
                                rel=1e-12, abs=1e-9)


def test_frechet_distance_retries_with_epsilon_as_jax(monkeypatch):
    """A first root that is not finite makes both retry on (S + eps I)."""
    real = scipy.linalg.sqrtm
    calls = []

    def flaky(m, *a, **k):
        calls.append(m)
        if len(calls) % 2 == 1:
            return np.full_like(m, np.nan)
        return real(m, *a, **k)

    monkeypatch.setattr(scipy.linalg, "sqrtm", flaky)
    m1, s1 = fid.gaussian_stats(_features())
    m2, s2 = fid.gaussian_stats(_features(seed=5))
    got = fid.frechet_distance(m1, s1, m2, s2, eps=1e-2)
    want = jax_fid.frechet_distance(m1, s1, m2, s2, eps=1e-2)
    assert len(calls) == 4
    np.testing.assert_allclose(calls[1], (s1 + 1e-2 * np.eye(6))
                               @ (s2 + 1e-2 * np.eye(6)))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["complex", "non-finite"])
def test_frechet_distance_refuses_as_jax(case):
    mu = np.zeros(2)
    if case == "complex":  # sqrt of diag(1, -1): imaginary part 1
        s1, s2, match = np.diag([1.0, -1.0]), np.eye(2), "complex"
    else:
        s1, s2, match = np.full((2, 2), np.inf), np.eye(2), "non-finite"
    for fn in (fid.frechet_distance, jax_fid.frechet_distance):
        with pytest.raises(ValueError, match=match):
            fn(mu, s1, mu, s2)


def test_fid_from_features_and_compute_fid_are_jax_s():
    fa, fb = _features(), _features(seed=6)
    assert fid.fid_from_features(fa, fb) == pytest.approx(
        jax_fid.fid_from_features(fa, fb), rel=1e-12)
    ia = np.random.default_rng(7).random((60, 4, 4, 3)) * 255
    ib = np.random.default_rng(8).random((60, 4, 4, 3)) * 255
    w = np.random.default_rng(9).normal(size=(48, 5))

    def feature_fn(batch):
        return np.tanh(batch.reshape(len(batch), -1) / 255.0 @ w)

    assert fid.compute_fid(ia, ib, feature_fn, 20) == pytest.approx(
        jax_fid.compute_fid(ia, ib, feature_fn, 20), rel=1e-12)
