"""The library ops no model uses, against the JAX package on the CPU, with
their gradients: ``ops/norm.py`` (``batchnorm_moving_stats`` in both
branches, ``layernorm``, ``cond_batchnorm``), ``ops/special.py``
(``minibatch_layer``, ``ladder``), ``ops/linear.py``'s weight
normalization, ``objectives/gan.py`` and ``objectives/gan_inference.py:
local_ep_dynamic``.

Parameters come from the JAX op's own init (``registry.init``), carried to
the port by ``train/checkpoint.py: params_from_jax``; every output and the
gradient of sum(out * c), c a fixed random cotangent, with respect to each
input and parameter (``jax.grad`` against autograd), in f32 within rtol
1e-5, atol 1e-6 of the array's largest magnitude (sums taken in another
order).
"""

import importlib
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.objectives import gan as jgan
from graphical_gan_tpu.objectives import gan_inference as jgi
from graphical_gan_tpu.ops import initializers as jinits
from graphical_gan_tpu.ops import norm as jnorm
from graphical_gan_tpu.ops import special as jspecial
from graphical_gan_tpu_torch.objectives import gan as tgan
from graphical_gan_tpu_torch.objectives import gan_inference as tgi
from graphical_gan_tpu_torch.ops import initializers as tinits
from graphical_gan_tpu_torch.ops import norm as tnorm
from graphical_gan_tpu_torch.ops import special as tspecial

from _torch_library import check, randn, jax_params

# the modules (the packages export the functions of these names)
jlinear = importlib.import_module("graphical_gan_tpu.ops.linear")
tlinear = importlib.import_module("graphical_gan_tpu_torch.ops.linear")


# -- ops/norm.py --------------------------------------------------------------

def _perturbed(params, seed=7):
    rng = np.random.default_rng(seed)
    return {k: (v + rng.standard_normal(v.shape) * 0.3).astype(np.float32)
            for k, v in params.items()}


MOVING_CASES = [  # (x shape, is_training, stats_iter, update)
    ((4, 3, 5, 6), True, 0, True),
    ((4, 3, 5, 6), True, 3, False),
    ((5, 6), True, 7, True),
    ((4, 3, 5, 6), False, 2, True),
    ((6, 2, 2, 3), False, 0, True),
    ((5, 6), False, 4, True)]


@pytest.mark.parametrize("shape,training,t,update", MOVING_CASES)
def test_batchnorm_moving_stats(shape, training, t, update):
    c = shape[-1]
    x = randn(shape, shift=0.5)
    mm = randn((c,), seed=2, scale=0.3)
    mv = np.abs(randn((c,), seed=3)) + 0.5
    params = _perturbed(jax_params(
        jnorm.batchnorm_moving_stats, "bn", jnp.asarray(x), training, t,
        jnp.asarray(mm), jnp.asarray(mv), update))
    assert set(params) == {"bn.offset", "bn.scale"}

    def jfn(x, mm, mv):
        return jnorm.batchnorm_moving_stats("bn", x, training, t, mm, mv,
                                            update)

    def tfn(p, x, mm, mv):
        return tnorm.batchnorm_moving_stats(p, "bn", x, training, t, mm, mv,
                                            update)

    check(jfn, tfn, params, [x, mm, mv], n_out=3)


@pytest.mark.parametrize("shape,axes", [((4, 6, 3, 3), [1, 2, 3]),
                                        ((5, 7), [1]),
                                        ((3, 4, 5), [1, 2]),
                                        ((2, 3, 4, 5), [2, 3])])
def test_layernorm(shape, axes):
    x = randn(shape, shift=0.3)
    params = _perturbed(jax_params(jnorm.layernorm, "ln", axes,
                                   jnp.asarray(x)))
    check(lambda x: jnorm.layernorm("ln", axes, x),
          lambda p, x: tnorm.layernorm(p, "ln", axes, x), params, [x])


@pytest.mark.parametrize("b,n_labels", [(6, 3), (4, 10)])
def test_cond_batchnorm(b, n_labels):
    x = randn((b, 4, 3, 5), shift=-0.2)
    labels = np.random.default_rng(5).integers(0, n_labels, b).astype(
        np.int32)
    params = _perturbed(jax_params(jnorm.cond_batchnorm, "cbn",
                                   jnp.asarray(x), jnp.asarray(labels),
                                   n_labels))
    assert params["cbn.offset"].shape == (n_labels, 5)
    check(lambda x, y: jnorm.cond_batchnorm("cbn", x, y, n_labels),
          lambda p, x, y: tnorm.cond_batchnorm(p, "cbn", x, y.long(),
                                               n_labels),
          params, [x, labels])


def test_norm_specs_are_the_jax_params():
    x = jnp.zeros((2, 3, 3, 4))
    for specs, fn, args in (
            (tnorm.batchnorm_specs("bn", 4), jnorm.batchnorm_moving_stats,
             ("bn", x, True, 0, jnp.zeros(4), jnp.ones(4))),
            (tnorm.layernorm_specs("ln", 3), jnorm.layernorm,
             ("ln", [1, 2, 3], x)),
            (tnorm.cond_batchnorm_specs("c", 5, 4), jnorm.cond_batchnorm,
             ("c", x, jnp.zeros(2, jnp.int32), 5))):
        want = jax_params(fn, *args)
        got = tinits.init_params(specs, 0, "cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# -- ops/special.py -----------------------------------------------------------

@pytest.mark.parametrize("b,n_in,k,d", [(5, 6, 3, 4), (3, 8, 2, 5)])
def test_minibatch_layer(b, n_in, k, d):
    x = randn((b, n_in), scale=0.2)
    params = jax_params(jspecial.minibatch_layer, "mb", n_in, k, d,
                        jnp.asarray(x))
    params["mb.W"] = params["mb.W"] * 0.3  # distances where exp(-d) lives
    params["mb.b"] = randn((k,), seed=4)
    assert params["mb.W"].shape == (n_in, k, d)
    check(lambda x: jspecial.minibatch_layer("mb", n_in, k, d, x),
          lambda p, x: tspecial.minibatch_layer(p, "mb", x), params, [x])


def test_ladder():
    z, u = randn((4, 6), seed=1), randn((4, 6), seed=2)
    params = _perturbed(jax_params(
        jspecial.ladder, (jnp.asarray(z), jnp.asarray(u)), 6, "lad"))
    assert len(params) == 9
    check(lambda z, u: jspecial.ladder((z, u), 6, "lad"),
          lambda p, z, u: tspecial.ladder(p, "lad", (z, u)), params, [z, u])


def test_special_specs_are_the_jax_params():
    want = jax_params(jspecial.ladder, (jnp.zeros((2, 6)),) * 2, 6, "lad")
    got = tinits.init_params(tspecial.ladder_specs("lad", 6), 0, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    specs = tspecial.minibatch_specs("mb", 200, 5, 4)
    want = jax_params(jspecial.minibatch_layer, "mb", 200, 5, 4,
                      jnp.zeros((2, 200)))
    got = tinits.init_params(specs, 0, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    bound = math.sqrt(2.0 / 200) * math.sqrt(3.0)
    for w in (got["mb.W"].numpy(), want["mb.W"]):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound


# -- ops/linear.py: weight normalization --------------------------------------

@pytest.mark.parametrize("weightnorm,biases,lead", [
    (True, True, (5,)), (True, False, (2, 3)), (False, False, (4,))])
def test_linear_weightnorm_and_biases(weightnorm, biases, lead):
    x = randn(lead + (7,))
    params = jax_params(jlinear.linear, "l", 7, 4, jnp.asarray(x), biases,
                        None, weightnorm)
    if weightnorm:  # g initialised from the columns' norms, then moved
        np.testing.assert_allclose(
            params["l.g"], np.sqrt((params["l.W"] ** 2).sum(0)), rtol=1e-6)
    params = _perturbed(params)
    check(lambda x: jlinear.linear("l", 7, 4, x, biases, None, weightnorm),
          lambda p, x: tlinear.linear(p, "l", x, biases, weightnorm),
          params, [x])


@pytest.mark.parametrize("init", [None, "lecun", "he", "glorot_he",
                                  "orthogonal", ("uniform", 0.3)])
def test_linear_specs_match_the_jax_init(init):
    """Names and shapes equal; the draws differ by RNG stream, so the
    values are held to the scheme: the scaled-uniform bound, an orthogonal
    matrix, U(-r, r); ``.g`` equals the drawn columns' norms."""
    specs = tlinear.linear_specs("l", 6, 6, initialization=init,
                                 weightnorm=True)
    got = tinits.init_params(specs, 3, "cpu")
    want = jax_params(jlinear.linear, "l", 6, 6, jnp.zeros((2, 6)), True,
                      init, True)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    w = got["l.W"].numpy()
    np.testing.assert_allclose(got["l.g"].numpy(),
                               np.sqrt((w ** 2).sum(0)), rtol=1e-6)
    if init == "orthogonal":
        for m in (w, want["l.W"]):
            np.testing.assert_allclose(m.T @ m, np.eye(6), atol=1e-5)
    else:
        bound = (init[1] if isinstance(init, tuple) else
                 tinits.linear_stdev(init, 6, 6) * math.sqrt(3.0))
        for m in (w, want["l.W"]):
            assert np.abs(m).max() <= bound * (1 + 1e-6)
    with pytest.raises(ValueError):
        tlinear.linear_specs("l", 6, 6, initialization="nope")
    with pytest.raises(ValueError):
        tlinear.linear_specs("l", 6, 6, initialization=("normal", 1.0))


def test_initializers_equal_jax():
    for args in ((3, 5, 4, 1, False), (3, 5, 4, 2, True), (8, 7, 3, 3,
                                                           False)):
        assert tinits.conv1d_fans(*args) == jinits.conv1d_fans(*args)
    gen = torch.Generator().manual_seed(0)
    u = tinits.uniform_range(0.25, (2000,), gen, gain=2.0).numpy()
    assert np.abs(u).max() <= 0.5 and np.abs(u).max() > 0.49
    n = tinits.normal((4000,), gen, stddev=3.0).numpy()
    assert abs(n.std() - 3.0) < 0.2
    assert tinits.zeros((2, 3)).sum() == 0 and tinits.ones((4,)).sum() == 4
    q = tinits.orthogonal((3, 8), gen).numpy()
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-5)
    with pytest.raises(ValueError):
        tinits.orthogonal((5,), gen)
    with pytest.raises(ValueError, match="unknown init kind"):
        tinits.init_params({"w": ("nope", (2,), ())}, 0, "cpu")


# -- objectives ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["wgan", "wgan_gp", "gan"])
def test_gan_objectives(name):
    f, r = randn((8, 1), seed=1), randn((8, 1), seed=2)
    extra = [np.float32(0.7)] if name == "wgan_gp" else []

    def jfn(*a):
        return getattr(jgan, name)(*a)

    def tfn(p, *a):
        return getattr(tgan, name)(*a)

    check(jfn, tfn, {}, [f, r] + [np.asarray(e) for e in extra], n_out=2)


@pytest.mark.parametrize("n_zz,rec", [(0, False), (2, True), (2, False),
                                      (1, True)])
def test_local_ep_dynamic(n_zz, rec):
    zz = [randn((6, 1), seed=10 + i) for i in range(2 * n_zz)]
    xz = [randn((6, 1), seed=1), randn((6, 1), seed=2)]
    extra = [np.asarray(np.float32(0.4))] if rec else []

    def split(a):
        return list(a[:n_zz]), list(a[n_zz:2 * n_zz]), a[2 * n_zz], \
            a[2 * n_zz + 1], (a[2 * n_zz + 2] if rec else None)

    check(lambda *a: jgi.local_ep_dynamic(*split(a)),
          lambda p, *a: tgi.local_ep_dynamic(*split(a)), {},
          zz + xz + extra, n_out=2)
