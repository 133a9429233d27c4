"""The conv options no model uses, against the JAX package on the CPU, with
their gradients (``ops/conv.py``): ``conv2d``'s causal masks 'a' and 'b',
weight normalization and ``biases=False`` (K1 with a zero bias, its plain
version here), ``deconv2d``'s weight normalization, ``biases=False`` and
VALID padding (``lax.conv_transpose``'s output size, H·s + max(k - s, 0),
at k in {3, 4, 5} and s in {1, 2}), and ``conv1d`` with its masks,
weight normalization, biases and TF's SAME pads. The factors are covered
pairwise. The ``*_specs`` functions give the JAX op's parameter names and
shapes, ``.g`` the drawn filter's norms as the JAX init computes them.

Tolerance: tests/_torch_library.py (f32, rtol 1e-5).
"""

import importlib
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu_torch.ops import initializers as tinits

from _torch_library import check, jax_params, randn

# the modules (the packages export the functions of these names)
jconv = importlib.import_module("graphical_gan_tpu.ops.conv")
tconv = importlib.import_module("graphical_gan_tpu_torch.ops.conv")


def _moved_g(params, seed=9):
    """``.g`` moved off the norms it was initialised to, so a wrong norm
    shows, and the biases drawn off 0: where a causal mask leaves a corner
    output only padding taps, a zero bias puts its pre-activation exactly
    on the activation's kink, whose slope JAX's ``max(alpha*x, x)`` and
    K1's backward (alpha at 0, JAX's Pallas ``_act_grad``) choose
    differently."""
    if "c.g" in params:
        params["c.g"] = params["c.g"] * (
            1.0 + 0.2 * randn(params["c.g"].shape, seed=seed))
    if "c.Biases" in params:
        params["c.Biases"] = randn(params["c.Biases"].shape, seed=seed + 1)
    return params


CONV2D = [  # (B, H, W, Cin, Cout, k, stride, padding, act, mask, wn, bias)
    (2, 7, 7, 3, 6, 3, 1, "SAME", None, ("a", 1), False, True),
    (2, 6, 5, 6, 6, 5, 1, "SAME", "leaky_relu", ("b", 3), True, False),
    (2, 9, 9, 3, 9, 3, 2, "VALID", "relu", ("a", 3), True, True),
    (2, 8, 8, 4, 5, 4, 2, "SAME", None, None, True, False),
    (2, 9, 8, 3, 3, 5, 2, "VALID", "leaky_relu", ("b", 1), False, False),
    (1, 6, 6, 2, 4, 3, 1, "VALID", "relu", None, False, False),
    (2, 7, 7, 6, 3, 3, 1, "SAME", "leaky_relu", ("a", 3), False, True)]


@pytest.mark.parametrize("case", CONV2D)
def test_conv2d_masks_weightnorm_biases(case):
    b, h, w, cin, cout, k, s, pad, act, mask, wn, bias = case
    x = randn((b, h, w, cin))

    def jfn(x):
        return jconv.conv2d("c", cin, cout, k, x, mask_type=mask, stride=s,
                            weightnorm=wn, biases=bias, padding=pad, act=act)

    params = _moved_g(jax_params(jfn, jnp.asarray(x)))
    assert ("c.Biases" in params) == bias and ("c.g" in params) == wn
    check(jfn, lambda p, x: tconv.conv2d(p, "c", x, s, pad, act, mask, wn,
                                         bias), params, [x])


DECONV = [  # (Hin, Cin, Cout, k, stride, padding, wn, bias)
    (4, 3, 5, 3, 1, "VALID", False, True),
    (4, 3, 5, 3, 2, "VALID", True, False),
    (5, 4, 2, 4, 1, "VALID", True, True),
    (3, 4, 2, 4, 2, "VALID", False, False),
    (4, 2, 3, 5, 1, "VALID", False, False),
    (3, 2, 3, 5, 2, "VALID", True, True),
    (4, 3, 4, 5, 2, "SAME", True, False),
    (5, 3, 4, 3, 1, "SAME", True, True)]


@pytest.mark.parametrize("case", DECONV)
def test_deconv2d_valid_weightnorm_biases(case):
    hin, cin, cout, k, s, pad, wn, bias = case
    x = randn((2, hin, hin, cin))

    def jfn(x):
        return jconv.deconv2d("c", cin, cout, k, x, weightnorm=wn,
                              biases=bias, stride=s, padding=pad)

    params = _moved_g(jax_params(jfn, jnp.asarray(x)))
    out = tconv.deconv2d(tinits.init_params(
        tconv.deconv2d_specs("c", cin, cout, k, weightnorm=wn, biases=bias,
                             stride=s), 0, "cpu"), "c",
        torch.from_numpy(x), s, pad, wn, bias)
    want_hw = hin * s if pad == "SAME" else hin * s + max(k - s, 0)
    assert out.shape == (2, want_hw, want_hw, cout)
    check(jfn, lambda p, x: tconv.deconv2d(p, "c", x, s, pad, wn, bias),
          params, [x])


CONV1D = [  # (B, W, Cin, Cout, k, stride, mask, wn, bias)
    (2, 9, 3, 4, 3, 1, ("a", 1), True, True),
    (2, 8, 6, 6, 5, 1, ("b", 3), False, False),
    (3, 7, 4, 5, 4, 2, None, True, False),
    (2, 11, 3, 6, 5, 2, ("a", 3), False, True),
    (1, 6, 2, 3, 1, 1, None, False, True)]


@pytest.mark.parametrize("case", CONV1D)
def test_conv1d(case):
    b, w, cin, cout, k, s, mask, wn, bias = case
    x = randn((b, w, cin))

    def jfn(x):
        return jconv.conv1d("c", cin, cout, k, x, mask_type=mask, stride=s,
                            weightnorm=wn, biases=bias)

    params = _moved_g(jax_params(jfn, jnp.asarray(x)))
    check(jfn, lambda p, x: tconv.conv1d(p, "c", x, s, mask, wn, bias),
          params, [x])


@pytest.mark.parametrize("mtype", ["a", "b"])
@pytest.mark.parametrize("mchan,k,cin,cout", [(1, 3, 3, 5), (3, 5, 6, 9),
                                              (3, 3, 3, 3)])
def test_masks_are_the_jax_masks(mtype, mchan, k, cin, cout):
    np.testing.assert_array_equal(
        tconv._mask(mtype, mchan, (k, k, cin, cout)),
        jconv._make_mask2d(mtype, mchan, k, cin, cout))
    np.testing.assert_array_equal(
        tconv._mask(mtype, mchan, (k, cin, cout)),
        jconv._make_mask1d(mtype, mchan, k, cin, cout))


@pytest.mark.parametrize("kind", ["conv2d", "deconv2d", "conv1d"])
@pytest.mark.parametrize("wn,bias,masked", [(True, False, True),
                                            (False, True, False)])
def test_specs_are_the_jax_params(kind, wn, bias, masked):
    """Names and shapes of the JAX init; the filter within the He bound of
    the JAX fans (masked halves them); ``.g`` equal to the JAX init's g of
    the same filter."""
    cin, cout, k, s = 8, 6, 3, 2
    mask = ("a", 1) if masked and kind != "deconv2d" else None
    kw = dict(weightnorm=wn, biases=bias)
    if kind == "conv2d":
        specs = tconv.conv2d_specs("c", cin, cout, k, mask_type=mask,
                                   stride=s, **kw)
        x = jnp.zeros((1, 6, 6, cin))
        fans = tinits.conv_fans(cin, cout, k, s, mask is not None)

        def jfn(**p):
            return jconv.conv2d("c", cin, cout, k, x, mask_type=mask,
                                stride=s, **kw)
    elif kind == "deconv2d":
        specs = tconv.deconv2d_specs("c", cin, cout, k, stride=s, **kw)
        x = jnp.zeros((1, 3, 3, cin))
        fans = tinits.deconv_fans(cin, cout, k, s)

        def jfn(**p):
            return jconv.deconv2d("c", cin, cout, k, x, stride=s, **kw)
    else:
        specs = tconv.conv1d_specs("c", cin, cout, k, mask_type=mask,
                                   stride=s, **kw)
        x = jnp.zeros((1, 6, cin))
        fans = tinits.conv1d_fans(cin, cout, k, s, mask is not None)

        def jfn(**p):
            return jconv.conv1d("c", cin, cout, k, x, mask_type=mask,
                                stride=s, **kw)

    got = tinits.init_params(specs, 1, "cpu")
    want = jax_params(jfn)
    assert {n: tuple(v.shape) for n, v in got.items()} == \
        {n: v.shape for n, v in want.items()}
    bound = tinits.he_or_glorot_stdev(*fans, he_init=True) * math.sqrt(3.0)
    for w in (got["c.Filters"].numpy(), want["c.Filters"]):
        assert bound * 0.8 < np.abs(w).max() <= bound * (1 + 1e-6)
    if wn:
        again = jax_params(jfn, seed_params={
            "c.Filters": jnp.asarray(got["c.Filters"].numpy())})
        np.testing.assert_allclose(got["c.g"].numpy(), again["c.g"],
                                   rtol=1e-6)
