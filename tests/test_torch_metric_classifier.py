"""The port's metric classifier (graphical_gan_tpu_torch/metrics/
classifier.py) against the JAX ``MetricClassifier``, with the JAX init's
weights carried over, at dim 8, on cifar10 (32x32x3) and mnist (28x28x1)
shapes: the parameters' names and shapes, trunk features and logits within
1e-4 of the largest |value|, three ``fit`` steps' parameters within 1e-3
of each leaf's largest |value| (the same ``RandomState`` index stream; the
biases a BN subtracts out, whose gradients are shown to be at rounding
level, within their Adam step bound), accuracy equal,
the prob and feature functions within 1e-4, and a classifier npz that
either package restores."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.metrics.jax_classifier import (
    MetricClassifier as JaxClassifier)
from graphical_gan_tpu.train import checkpoint as jax_ckpt
from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib


# -- the metric classifier ------------------------------------------------------------

SHAPES = {"cifar10": ((32, 32), 3), "mnist": ((28, 28), 1)}
BIASES_BEFORE_BN = ("Classifier.2.Biases", "Classifier.3.Biases")


@functools.lru_cache(maxsize=None)
def _jax_init(dataset, dim=8):
    """(JAX classifier, its init as numpy): read-only, shared by tests."""
    hw, c = SHAPES[dataset]
    jc = JaxClassifier(image_hw=hw, channels=c, n_classes=10, dim=dim)
    init = jax.jit(jc.init)(jax.random.PRNGKey(1))  # one compile, not per op
    return jc, {k: np.asarray(v) for k, v in init.items()}


def _pair(dataset, dim=8):
    hw, c = SHAPES[dataset]
    tc = MetricClassifier(image_hw=hw, channels=c, n_classes=10, dim=dim,
                          device="cpu")
    jc, jp = _jax_init(dataset, dim)
    return jc, tc, jp


def _data(dataset, n, seed=0):
    hw, c = SHAPES[dataset]
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, c * hw[0] * hw[1])).astype(np.int32)
    return x, rng.integers(0, 10, n).astype(np.int64)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_classifier_params_are_the_jax_names_and_shapes(dataset):
    jc, tc, jp = _pair(dataset)
    tp = tc.init(0)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_classifier_trunk_and_logits_are_jax_s(dataset):
    jc, tc, jp = _pair(dataset)
    tp = ckpt_lib.params_from_jax(jp, "cpu")
    x, _ = _data(dataset, 16)
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    want_f = registry.apply(lambda: jc.trunk(jnp.asarray(x)), jparams, None)
    want_l = registry.apply(lambda: jc.forward(jnp.asarray(x)), jparams,
                            None)
    with torch.no_grad():
        got_f = tc.trunk(tp, x).numpy()
        got_l = tc.forward(tp, torch.from_numpy(x)).numpy()
    assert got_f.shape == (16, 32) and got_l.shape == (16, 10)
    assert _rel(got_f, want_f) < 1e-4
    assert _rel(got_l, want_l) < 1e-4


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_classifier_fit_steps_are_jax_s(dataset):
    """Three steps of TF1 Adam (1e-3, 0.9, 0.999) from the same weights on
    the same ``RandomState(seed)`` index stream."""
    jc, tc, jp = _pair(dataset)
    x, y = _data(dataset, 40, seed=1)
    steps, b, seed = 3, 16, 5
    step, opt_init = jc.make_train_step(1e-3)
    params = {k: jnp.asarray(v) for k, v in jp.items()}
    opt_state = opt_init(params)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        idx = rng.randint(0, len(x), size=b)
        params, opt_state, _, _ = step(params, opt_state,
                                       jnp.asarray(x[idx]),
                                       jnp.asarray(y[idx].astype(np.int32)))
    got = tc.fit(x, y, steps=steps, batch_size=b, seed=seed,
                 params=ckpt_lib.params_from_jax(jp, "cpu"))
    for name, want in params.items():
        if name in BIASES_BEFORE_BN:
            # a bias the next BN subtracts out has a gradient of 0 up to
            # rounding, which Adam scales to steps of lr: each side moves
            # at most steps * lr from the same start
            for side in (got[name].numpy(), np.asarray(want)):
                assert np.abs(side - jp[name]).max() <= steps * 1e-3 * (
                    1 + 1e-6), name
        else:
            assert _rel(got[name].numpy(), want) < 1e-3, name


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_classifier_biases_before_bn_have_rounding_level_gradients(dataset):
    """What the fit test's exclusion rests on: at the first step's batch,
    in both packages, the gradients of the two biases a BN subtracts out
    are below 1e-5 of the largest gradient (f32 rounding of a sum over the
    BN's rows), while every other leaf's is above 1e-2 of it."""
    jc, tc, jp = _pair(dataset)
    x, y = _data(dataset, 40, seed=1)
    idx = np.random.RandomState(5).randint(0, len(x), size=16)
    xb, yb = x[idx], y[idx]

    def jax_loss(params):
        logits = registry.apply(lambda: jc.forward(jnp.asarray(xb)),
                                params, None)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(yb)[:, None],
                                             axis=1))

    jg = jax.jit(jax.grad(jax_loss))(  # one compile, not per op
        {k: jnp.asarray(v) for k, v in jp.items()})
    leaves = {k: v.requires_grad_(True)
              for k, v in ckpt_lib.params_from_jax(jp, "cpu").items()}
    logp = torch.log_softmax(tc.forward(leaves, xb), dim=1)
    nll = -logp.gather(1, torch.from_numpy(yb)[:, None]).mean()
    tg = torch.autograd.grad(nll, list(leaves.values()))
    for grads in ({k: np.asarray(v) for k, v in jg.items()},
                  {k: g.numpy() for k, g in zip(leaves, tg)}):
        top = {k: float(np.abs(g).max()) for k, g in grads.items()}
        largest = max(top.values())
        for name, m in top.items():
            if name in BIASES_BEFORE_BN:
                assert m < 1e-5 * largest, name
            else:
                assert m > 1e-2 * largest, name


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_classifier_accuracy_and_scoring_fns_are_jax_s(dataset):
    """accuracy over batches of 512 with a partial last one; the prob and
    feature functions on HWC images (floats truncate to ints)."""
    jc, tc, jp = _pair(dataset)
    x, y = _data(dataset, 520, seed=2)
    tp = ckpt_lib.params_from_jax(jp, "cpu")
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    # labels the classifier gets right about half the time
    with torch.no_grad():
        pred = tc.forward(tp, x).argmax(dim=1).numpy()
    y = np.where(np.arange(len(y)) % 2 == 0, pred, y)
    assert tc.accuracy(tp, x, y) == jc.accuracy(jparams, x, y)
    hw, c = SHAPES[dataset]
    hwc = x[:20].reshape(20, c, *hw).transpose(0, 2, 3, 1) + 0.7
    assert _rel(tc.as_prob_fn(tp)(hwc), jc.as_prob_fn(jparams)(hwc)) < 1e-4
    assert _rel(tc.as_feature_fn(tp)(hwc),
                jc.as_feature_fn(jparams)(hwc)) < 1e-4


def test_classifier_npz_restores_in_either_package(tmp_path):
    jc, tc, jp = _pair("cifar10")
    tp = tc.init(3)
    path = str(tmp_path / "port.npz")
    ckpt_lib.save_dict(path, tp, {"dim": 8})
    like = {k: jnp.asarray(v) for k, v in jp.items()}
    restored, extra = jax_ckpt.restore(path, like)
    assert extra == {"dim": 8}
    for k, v in tp.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v.numpy())
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save(path, like, {"dim": 8})
    flat, _ = ckpt_lib.load_raw(path)
    back = ckpt_lib.params_from_jax(ckpt_lib.dict_of(flat), "cpu")
    assert set(back) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
