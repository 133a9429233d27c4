"""K2c/K2d (graphical_gan_tpu_torch/ops/kernels/fused_norm.py: the plain
versions of bn_bwd_reduce and bn_bwd_apply, and FusedBatchNormAct's
gradients) against ``jax.grad`` of the JAX ``fused_batchnorm_act``, whose
custom VJP is the Pallas ``_bwd`` run in interpret mode on the CPU, as
tests/test_pallas.py runs it. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py.

Tolerances. f32: the two sides sum the same f32 terms in another order and
take the variance by another formula (the Pallas E[x²] - mean², the port
(x - mean)²), so dscale and doffset agree to atol 1e-4·sqrt(R) with rtol
1e-4 (sums over R rows of O(1) terms), and dx to atol 1e-4 scaled by
max(1, max |dx|): inv multiplies the variance formulas' difference, and
with G.BN1's 4 rows a channel's spread can be small, its inv and dx large
(the largest |Δdx| seen, 6.2e-4, was at max |dx| = 12.9). bf16: inputs and dx are bf16 on
both sides and the arithmetic is f32; dx may differ by one bf16 rounding
(2^-8 relative), so |Δdx| <= 2e-2 * max(1, max |dx|); the f32 sums keep
the f32 tolerance scaled by the bf16 inputs' size.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas import fused_batchnorm_act as jax_fused
from graphical_gan_tpu_torch.ops.kernels import fused_norm

ACTS = [None, "relu", "leaky_relu"]
SHAPES = [
    (4, 8, 8, 16),   # [B*h*w, C] conv form, R = 256
    (4, 4096),       # G.BN1's dense form [B, 4*4*4*dim] at dim 64
    (196, 16),       # R not a multiple of any row block
    (3, 5),          # C not a multiple of 4 (the scalar apply)
]


def _inputs(shape):
    rng = np.random.RandomState(len(shape) + shape[-1])
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype("float32")
    g = rng.randn(*shape).astype("float32")
    scale = (rng.rand(c) + 0.5).astype("float32")
    offset = (rng.randn(c) * 0.5).astype("float32")
    return x, g, scale, offset


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, act, dtype):
    """(dx, dscale, doffset) of sum(y * g) through the Pallas custom VJP,
    on ``_inputs(shape)``; both tests read the same reference."""
    x, g, scale, offset = _inputs(shape)

    def loss(xx, s, o):
        y = jax_fused(xx, s, o, act).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(g))

    dx, ds, do = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(offset))
    return (np.asarray(dx.astype(jnp.float32)), np.asarray(ds),
            np.asarray(do))


def _close(got, want, dtype, scale=None):
    """``scale`` None: the dx rule, relative to max(1, max |want|)."""
    got = np.asarray(got, np.float32)
    size = max(1.0, float(np.abs(want).max()))
    if dtype == "bfloat16":
        assert float(np.abs(got - want).max()) <= 2e-2 * size
    else:
        np.testing.assert_allclose(got, want, atol=1e-4 * (scale or size),
                                   rtol=1e-4)


def _torch(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_reduce_and_apply_match_pallas_bwd(shape, act, dtype):
    x, g, scale, offset = _inputs(shape)
    dx_ref, ds_ref, do_ref = _jax_grads(shape, act, dtype)
    c = shape[-1]
    x2d = _torch(x, dtype).reshape(-1, c)
    g2d = _torch(g, dtype).reshape(-1, c)
    mean, _, inv = fused_norm.bn_stats(x2d)
    red = fused_norm.bn_bwd_reduce(g2d, x2d, mean, inv, _torch(scale),
                                   _torch(offset), act)
    dx = fused_norm.bn_bwd_apply(g2d, x2d, mean, inv, _torch(scale),
                                 _torch(offset), red, act)
    assert red.shape == (2, c) and red.dtype == torch.float32
    assert dx.dtype == x2d.dtype and dx.shape == x2d.shape
    rows = x2d.shape[0]
    _close(red[0].numpy(), do_ref, "float32", scale=np.sqrt(rows))
    _close(red[1].numpy(), ds_ref, "float32", scale=np.sqrt(rows))
    _close(dx.float().reshape(shape).numpy(), dx_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_function_gradients_match_jax_grad(shape, act, dtype):
    x, g, scale, offset = _inputs(shape)
    dx_ref, ds_ref, do_ref = _jax_grads(shape, act, dtype)
    xt = _torch(x, dtype).requires_grad_(True)
    st = _torch(scale).requires_grad_(True)
    ot = _torch(offset).requires_grad_(True)
    y = fused_norm.fused_batchnorm_act(xt, st, ot, act)
    assert y.dtype == xt.dtype
    dx, ds, do = torch.autograd.grad((y.float() * _torch(g)).sum(),
                                     [xt, st, ot])
    assert dx.dtype == xt.dtype and ds.dtype == do.dtype == torch.float32
    rows = int(np.prod(shape[:-1]))
    _close(dx.float().numpy(), dx_ref, dtype)
    _close(ds.numpy(), ds_ref, "float32", scale=np.sqrt(rows))
    _close(do.numpy(), do_ref, "float32", scale=np.sqrt(rows))


def test_backward_is_not_differentiable_again():
    """The backward differentiates once more (the mnist D's BNs sit inside
    wali-gp's penalty; test_torch_fused_norm_double_bwd.py holds that
    second order against JAX), and the second order's own backward is not
    differentiable again: a third order raises instead of returning a
    wrong one."""
    x = torch.randn(8, 4, requires_grad=True)
    y = fused_norm.fused_batchnorm_act(x, torch.ones(4), torch.zeros(4),
                                       "relu")
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    (d2x,) = torch.autograd.grad(dx.square().sum(), x, create_graph=True)
    assert torch.isfinite(d2x).all()
    with pytest.raises(RuntimeError, match="once_differentiable"):
        d2x.sum().backward()


def test_cpu_backward_launches_no_kernel():
    before = (fused_norm.bn_bwd_reduce.launches,
              fused_norm.bn_bwd_apply.launches)
    x = torch.randn(6, 3, requires_grad=True)
    fused_norm.fused_batchnorm_act(x, torch.ones(3), torch.zeros(3),
                                   "leaky_relu").sum().backward()
    assert x.grad is not None
    assert (fused_norm.bn_bwd_reduce.launches,
            fused_norm.bn_bwd_apply.launches) == before
