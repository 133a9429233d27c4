"""K2's plain versions (graphical_gan_tpu_torch/ops/kernels/fused_norm.py)
against the JAX ``fused_batchnorm_act`` Pallas kernel, run in interpret mode
on the CPU as tests/test_pallas.py runs it, over that file's cases; and a
large-mean input against the JAX jnp path (ops/norm.py). The CUDA kernels
are held against these plain versions on the card by chip_smoke.py.

Tolerance: atol 1e-4 (test_pallas.py's), bf16 output within 2e-2.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.ops import batchnorm as jax_batchnorm
from graphical_gan_tpu.ops.pallas import fused_batchnorm_act as jax_fused
from graphical_gan_tpu_torch.ops.kernels import fused_norm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
def test_plain_matches_pallas_forward(act):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 7, 7, 32) * 2 + 1).astype("float32")
    scale = (rng.rand(32) + 0.5).astype("float32")
    offset = rng.randn(32).astype("float32")
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(offset), act))
    got = fused_norm.fused_batchnorm_act(_t(x), _t(scale), _t(offset), act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("shape", [(196, 16), (8, 64), (3, 5)])
def test_plain_matches_pallas_nonaligned_rows(shape):
    """Row counts that tile badly (test_pallas.py's 196) and the dense
    G.BN1 form [B, F] with few rows."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype("float32")
    c = shape[-1]
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.ones((c,)),
                                jnp.zeros((c,)), "relu"))
    got = fused_norm.fused_batchnorm_act(_t(x), torch.ones(c), torch.zeros(c),
                                         "relu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_plain_matches_registry_batchnorm_relu():
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(4, 8, 8, 8).astype("float32"))
    out_ref, params = registry.init(
        lambda xx: jnp.maximum(jax_batchnorm("bn", xx), 0),
        jax.random.PRNGKey(0), x)
    got = fused_norm.fused_batchnorm_act(
        _t(x), _t(params["bn.scale"]), _t(params["bn.offset"]), "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(out_ref), atol=1e-4)


def test_plain_bf16_matches_pallas():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 8, 8, 16) * 2).astype("float32")
    scale = (rng.rand(16) + 0.5).astype("float32")
    offset = rng.randn(16).astype("float32")
    want = np.asarray(jax_fused(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(scale), jnp.asarray(offset),
                                "leaky_relu"), np.float32)
    got = fused_norm.fused_batchnorm_act(_t(x).bfloat16(), _t(scale),
                                         _t(offset), "leaky_relu")
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) < 2e-2 * max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(64, 128), (8, 256)])
def test_large_mean_matches_jnp_path(shape):
    """Mean 1e3 against a spread of 1: the plain two-pass statistics agree
    with the JAX jnp path (jnp.mean / jnp.var) and with float64, where a
    sum of squares (E[x²] - mean²) in f32 would lose most of the digits.
    f32 holds 1e3 only to 6.1e-5, so two f32 means may differ by a few of
    those steps, and so may the normalized outputs (inv ~ 1): atol 5e-4."""
    rng = np.random.RandomState(5)
    x = (rng.randn(*shape) + 1e3).astype("float32")
    c = shape[-1]

    def f(xx):
        return jax_batchnorm("bn", xx)

    want, params = registry.init(f, jax.random.PRNGKey(0), jnp.asarray(x))
    got = fused_norm.fused_batchnorm_act(_t(x), _t(params["bn.scale"]),
                                         _t(params["bn.offset"]), None)
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean(axis=0)) / np.sqrt(x64.var(axis=0) + 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    np.testing.assert_allclose(got.numpy(), exact, atol=5e-4)
    np.testing.assert_allclose(np.asarray(want), exact, atol=5e-4)
    mean, var, inv = fused_norm.bn_stats(_t(x))
    np.testing.assert_allclose(var.numpy(), x64.var(axis=0), rtol=1e-4)
    np.testing.assert_allclose(mean.numpy(), x64.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), 1 / np.sqrt(x64.var(axis=0)
                                                        + 1e-5), rtol=1e-4)
    assert mean.shape == var.shape == inv.shape == (c,)


def test_stats_and_apply_compose_to_fused():
    rng = np.random.RandomState(6)
    x = _t(rng.randn(32, 8))
    scale, offset = _t(rng.rand(8) + 0.5), _t(rng.randn(8))
    mean, _, inv = fused_norm.bn_stats(x)
    y = fused_norm.bn_apply(x, mean, inv, scale, offset, "relu")
    torch.testing.assert_close(
        y, fused_norm.fused_batchnorm_act(x, scale, offset, "relu"))


def test_cpu_wrappers_do_not_count():
    before = (fused_norm.bn_stats.launches, fused_norm.bn_apply.launches)
    fused_norm.fused_batchnorm_act(torch.randn(4, 3), torch.ones(3),
                                   torch.zeros(3), "relu")
    assert (fused_norm.bn_stats.launches,
            fused_norm.bn_apply.launches) == before
