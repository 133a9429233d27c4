"""``conv2d_bias_act``'s backward (graphical_gan_tpu_torch/ops/kernels/
fused_conv.py: FusedConv2dBiasAct) against ``jax.grad`` of the JAX ``fused_conv2d_bias_act``,
whose custom VJP runs the Pallas forward in interpret mode on the CPU; a
second-order gradient (d/dw of ||dx||², what the wali-gp penalty takes)
against ``jax.grad(jax.grad(...))`` of the XLA path (``ops.conv.conv2d``,
Pallas off), which tests/test_pallas_conv.py does not cover; and
``deconv2d``'s gradients against the VJP of the JAX ``deconv2d``
(``lax.conv_transpose`` with TF's asymmetric SAME pads).

Tolerances: f32 throughout; sums of up to 5·5·Cin·B·OH·OW products taken
in another order, so atol 1e-4 scaled by max(1, max |ref|), rtol 1e-4.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.ops import conv as jax_conv
from graphical_gan_tpu.ops.pallas import enable_pallas
from graphical_gan_tpu.ops.pallas.fused_conv import (
    fused_conv2d_bias_act as jax_fused)
from graphical_gan_tpu_torch.ops import deconv2d
from graphical_gan_tpu_torch.ops.kernels import fused_conv

# the E/D shapes at dim 8, B 2: 32/16/8 px, k5 s2 SAME
SHAPES = [(2, 32, 32, 3, 8), (2, 16, 16, 8, 16), (2, 8, 8, 16, 32)]
ACTS = [None, "relu", "leaky_relu"]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed + h)
    x = rng.randn(b, h, w, cin).astype("float32")
    wt = (rng.randn(5, 5, cin, cout) * 0.2).astype("float32")
    bias = (rng.randn(cout) * 0.1).astype("float32")
    g = rng.randn(b, -(-h // 2), -(-w // 2), cout).astype("float32")
    return x, wt, bias, g


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    size = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * size, rtol=1e-4)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}px")
def test_first_order_matches_pallas_vjp(shape, act):
    x, wt, bias, g = _inputs(shape)

    def loss(xx, ww, bb):
        return jnp.sum(jax_fused(xx, ww, bb, 2, "SAME", act) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(x, wt, bias)
    xt, wtt, bt = _leaves(x, wt, bias)
    y = fused_conv.conv2d_bias_act(xt, wtt, bt, 2, "SAME", act)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [xt, wtt, bt])
    for a, b in zip(got, want):
        _close(a, b)


def _jax_xla_conv(x, w, b, act):
    def f():
        return jax_conv.conv2d("c", w.shape[2], w.shape[3], 5, x, stride=2,
                               act=act)
    return registry.apply(f, {"c.Filters": w, "c.Biases": b},
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}px")
def test_second_order_matches_xla_path(shape, act):
    """d/d(w, b) of ||d<y, g>/dx||²: the backward differentiated again."""
    x, wt, bias, g = _inputs(shape, seed=1)
    enable_pallas(False)

    def dx_sq(ww, bb):
        dx = jax.grad(lambda xx: jnp.sum(_jax_xla_conv(xx, ww, bb, act) * g)
                      )(x)
        return jnp.sum(dx * dx)

    want_w, want_b = jax.grad(dx_sq, argnums=(0, 1))(wt, bias)
    xt, wtt, bt = _leaves(x, wt, bias)
    y = fused_conv.conv2d_bias_act(xt, wtt, bt, 2, "SAME", act)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt,
                                create_graph=True)
    got_w, got_b = torch.autograd.grad(dx.square().sum(), [wtt, bt],
                                       allow_unused=True)
    _close(got_w, want_w)
    # dx depends on the bias only through act'(y), which is piecewise
    # constant: both sides' bias gradient is zero
    assert got_b is None or float(got_b.abs().max()) == 0.0
    assert float(np.abs(np.asarray(want_b)).max()) == 0.0


def test_backward_computes_only_what_autograd_asks_for(monkeypatch):
    """A D conv in the G update (frozen filters) and on data (no input
    gradient): the backward is asked for, and returns, only the rest."""
    x, wt, bias, _ = _inputs(SHAPES[1])
    seen = []
    orig = fused_conv.conv2d_bias_act_backward

    def spy(*a, needs):
        out = orig(*a, needs=needs)
        seen.append((tuple(needs), tuple(t is not None for t in out)))
        return out

    monkeypatch.setattr(fused_conv, "conv2d_bias_act_backward", spy)
    for grads in ((True, False, False), (False, True, True)):
        args = [torch.from_numpy(a).requires_grad_(r)
                for a, r in zip((x, wt, bias), grads)]
        fused_conv.conv2d_bias_act(*args, 2, "SAME", "leaky_relu"
                                         ).sum().backward()
    assert seen == [((True, False, False),) * 2, ((False, True, True),) * 2]


@pytest.mark.parametrize("hw,cin,cout", [(4, 16, 8), (8, 8, 4),
                                         (16, 4, 3)])
def test_deconv_gradients_match_conv_transpose_vjp(hw, cin, cout):
    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, cin).astype("float32")
    w = (rng.randn(5, 5, cout, cin) * 0.2).astype("float32")
    b = rng.randn(cout).astype("float32")
    g = rng.randn(2, 2 * hw, 2 * hw, cout).astype("float32")

    def f(xx, ww, bb):
        return registry.apply(
            lambda: jax_conv.deconv2d("d", cin, cout, 5, xx),
            {"d.Filters": ww, "d.Biases": bb}, jax.random.PRNGKey(0))

    out, vjp = jax.vjp(f, x, w, b)
    want = vjp(jnp.asarray(g))
    xt, wtt, bt = _leaves(x, w, b)
    y = deconv2d({"d.Filters": wtt, "d.Biases": bt}, "d", xt)
    _close(y, out)
    got = torch.autograd.grad(y, [xt, wtt, bt], torch.from_numpy(g))
    for a, b_ in zip(got, want):
        _close(a, b_)
