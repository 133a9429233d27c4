"""The port's ops (graphical_gan_tpu_torch/ops) against the JAX package's, on
the CPU, from the same numpy inputs and parameters.

Tolerances: f32 atol 1e-5 (the JAX op tests' own); bf16 max |Δ| within
2e-2 of max(1, max |ref|), as tests/test_conv_gemm.py states it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu import ops as jops
from graphical_gan_tpu.core import registry
from graphical_gan_tpu.ops import activations as jacts
from graphical_gan_tpu.ops import initializers as jinits
from graphical_gan_tpu.ops import norm as jnorm
from graphical_gan_tpu_torch import ops as tops
from graphical_gan_tpu_torch.ops import initializers as tinits

KEY = jax.random.PRNGKey(0)
F32_ATOL = 1e-5
BF16_REL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _run_jax(fn, params):
    out = registry.apply(fn, {k: jnp.asarray(v) for k, v in params.items()},
                         KEY)
    return np.asarray(out.astype(jnp.float32))


def _tp(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _assert_close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) / scale < BF16_REL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_linear(dtype, lead):
    rng = np.random.default_rng(0)
    jd, td = DTYPES[dtype]
    x = rng.standard_normal(lead + (7,)).astype(np.float32)
    params = {"l.W": rng.standard_normal((7, 4)).astype(np.float32),
              "l.b": rng.standard_normal(4).astype(np.float32)}
    want = _run_jax(lambda: jops.linear("l", 7, 4, jnp.asarray(x, jd)),
                    params)
    got = tops.linear(_tp(params), "l", torch.from_numpy(x).to(td))
    assert got.dtype == td
    _assert_close(got, want, dtype)


CONV_CASES = [
    # (B, H, W, Cin, Cout, K, stride, padding, act)
    (2, 32, 32, 3, 8, 5, 2, "SAME", "leaky_relu"),   # E.1 at dim=8
    (2, 16, 16, 8, 16, 5, 2, "SAME", None),          # E.2
    (2, 8, 8, 16, 32, 5, 2, "SAME", None),           # E.3
    (2, 7, 7, 3, 5, 5, 2, "SAME", "relu"),           # odd size, pads (1,2)
    (2, 6, 6, 4, 3, 4, 1, "VALID", None),
    (2, 9, 9, 8, 8, 3, 1, "SAME", "leaky_relu"),     # stride 1
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d(case, dtype):
    b, h, w, cin, cout, k, s, pad, act = case
    rng = np.random.default_rng(1)
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    params = {"c.Filters": (rng.standard_normal((k, k, cin, cout)) * 0.2
                            ).astype(np.float32),
              "c.Biases": rng.standard_normal(cout).astype(np.float32)}
    want = _run_jax(lambda: jops.conv2d("c", cin, cout, k, jnp.asarray(x, jd),
                                        stride=s, padding=pad, act=act),
                    params)
    got = tops.conv2d(_tp(params), "c", torch.from_numpy(x).to(td), stride=s,
                      padding=pad, act=act)
    assert got.dtype == td
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hin,cin,cout", [(4, 32, 16), (8, 16, 8),
                                          (16, 8, 3)])
def test_deconv2d_same_stride2(hin, cin, cout, dtype):
    """G.2 (4->8), G.3 (8->16), G.5 (16->32) at dim=8: TF SAME transpose
    conv is asymmetric (lo=1); the port crops after padding=0."""
    rng = np.random.default_rng(3)
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((2, hin, hin, cin)).astype(np.float32)
    params = {"d.Filters": (rng.standard_normal((5, 5, cout, cin)) * 0.2
                            ).astype(np.float32),
              "d.Biases": rng.standard_normal(cout).astype(np.float32)}
    want = _run_jax(lambda: jops.deconv2d("d", cin, cout, 5,
                                          jnp.asarray(x, jd)), params)
    got = tops.deconv2d(_tp(params), "d", torch.from_numpy(x).to(td))
    assert got.shape == (2, 2 * hin, 2 * hin, cout) and got.dtype == td
    assert got.is_contiguous()
    _assert_close(got, want, dtype)


def test_deconv2d_valid_waits():
    """deconv2d's VALID padding, once refused, is lax.conv_transpose's:
    [B, H*s + max(k - s, 0), ...] (tests/test_torch_conv_library.py holds
    it to JAX at more shapes, with gradients)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    params = {"d.Filters": rng.standard_normal((5, 5, 3, 2)).astype(
        np.float32), "d.Biases": rng.standard_normal(3).astype(np.float32)}
    want = _run_jax(lambda: jops.deconv2d("d", 2, 3, 5, jnp.asarray(x),
                                          padding="VALID"), params)
    got = tops.deconv2d(_tp(params), "d", torch.from_numpy(x),
                        padding="VALID")
    assert got.shape == (1, 11, 11, 3)
    _assert_close(got, want, "float32")


BN_CASES = [
    # (shape, axes, act): conv form, dense axes=[0] form (G.BN1), and a
    # generic keepdims form
    ((4, 6, 6, 8), None, "relu"),
    ((4, 6, 6, 8), None, "leaky_relu"),
    ((4, 6, 6, 8), None, None),
    ((8, 32), [0], "relu"),
    ((4, 5, 6), [0, 1], None),
]


def _bn_params(shape, axes, rng):
    if axes is None or tuple(axes) == tuple(range(len(shape) - 1)):
        pshape = (shape[-1],)
    else:
        pshape = tuple(1 if i in axes else d for i, d in enumerate(shape))
    return {"bn.scale": (rng.random(pshape) + 0.5).astype(np.float32),
            "bn.offset": rng.standard_normal(pshape).astype(np.float32)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,axes,act", BN_CASES)
def test_batchnorm_act(shape, axes, act, dtype):
    rng = np.random.default_rng(4)
    jd, td = DTYPES[dtype]
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    params = _bn_params(shape, axes, rng)
    want = _run_jax(lambda: jnorm.batchnorm_act("bn", jnp.asarray(x, jd),
                                                act, axes=axes), params)
    got = tops.batchnorm_act(_tp(params), "bn", torch.from_numpy(x).to(td),
                             act, axes=axes)
    assert got.dtype == td
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("shape,axes,act", BN_CASES[2:])
def test_batchnorm_plain(shape, axes, act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    params = _bn_params(shape, axes, rng)
    want = _run_jax(lambda: jops.batchnorm("bn", jnp.asarray(x), axes=axes),
                    params)
    got = tops.batchnorm(_tp(params), "bn", torch.from_numpy(x), axes=axes)
    _assert_close(got, want, "float32")


def test_layout_round_trip_matches_jax():
    rng = np.random.default_rng(6)
    flat = rng.standard_normal((3, 2 * 4 * 5)).astype(np.float32)
    j = np.asarray(jops.unflatten_image(jnp.asarray(flat), 2, 4, 5))
    t = tops.unflatten_image(torch.from_numpy(flat), 2, 4, 5)
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.is_contiguous()
    np.testing.assert_array_equal(tops.flatten_image(t).numpy(), flat)
    np.testing.assert_array_equal(
        tops.flatten_image(t).numpy(),
        np.asarray(jops.flatten_image(jnp.asarray(j))))


@pytest.mark.parametrize("name", [None, "relu", "leaky_relu"])
def test_activations_match_jax(name):
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_array_equal(
        tops.activation(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jacts.activation(name)(jnp.asarray(x))))
    assert tops.LEAKY_ALPHA == jacts.LEAKY_ALPHA


def test_dropout_is_identity_unless_training():
    x = torch.randn(4, 5)
    assert tops.dropout(x, 0.2) is x
    g = torch.Generator().manual_seed(0)
    y = tops.dropout(torch.ones(1000, 10), 0.2, training=True, generator=g)
    kept = (y != 0).float().mean().item()
    assert 0.75 < kept < 0.85
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.8))


@pytest.mark.parametrize("args", [(3, 64, 5, 2), (64, 128, 5, 2),
                                  (1, 8, 4, 1), (7, 9, 3, 2)])
def test_fans_match_jax(args):
    assert tinits.conv_fans(*args) == jinits.conv_fans(*args, masked=False)
    assert tinits.conv_fans(*args, masked=True) == jinits.conv_fans(
        *args, masked=True)
    assert tinits.deconv_fans(*args) == jinits.deconv_fans(*args)
    fi, fo = tinits.conv_fans(*args)
    for he in (True, False):
        assert tinits.he_or_glorot_stdev(fi, fo, he) == \
            jinits.he_or_glorot_stdev(fi, fo, he)
    for scheme in ("lecun", "glorot", None, "he", "glorot_he"):
        assert tinits.linear_stdev(scheme, args[0], args[1]) == \
            jinits.linear_stdev(scheme, args[0], args[1])


def test_scaled_uniform_statistics():
    g = torch.Generator().manual_seed(0)
    w = tinits.scaled_uniform(0.1, (200, 300), g)
    bound = 0.1 * 3 ** 0.5
    assert w.shape == (200, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - 0.1) < 2e-3
    assert abs(float(w.mean())) < 2e-3
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(w, tinits.scaled_uniform(0.1, (200, 300), g2))
