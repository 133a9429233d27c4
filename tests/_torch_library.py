"""Shared by the library-op tests (tests/test_torch_library_ops.py,
tests/test_torch_conv_library.py): the JAX op's own initial parameters,
and one op's outputs and gradients through the JAX registry against the
port, on the CPU.

Tolerance: f32, rtol 1e-5 with an atol of 1e-6 of the array's largest
magnitude (the same sums in another order).
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax

from _torch_gmgan import FAST

KEY = jax.random.PRNGKey(0)
RTOL = 1e-5
ATOL_REL = 1e-6


def assert_close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale,
                               err_msg=what)


def compiled(jitted, *args):
    return jitted.lower(*args).compile(FAST)


def jax_params(fn, *args, key=KEY, seed_params=None):
    """The JAX op's own initial parameters (``registry.init`` of
    ``fn(*args)``, jitted: the forward, whose output init drops, compiles
    away), as numpy arrays. ``seed_params`` are taken as given."""
    seed = dict(seed_params or {})

    def init(key, seed):
        return registry.init(lambda: fn(*args), key, params=seed)[1]

    p = compiled(jax.jit(init), key, seed)(key, seed)
    return {k: np.asarray(v) for k, v in p.items()}


def check(jax_fn, torch_fn, params, inputs, seed=0, n_out=1):
    """Outputs of ``jax_fn(*inputs)`` (under the JAX registry) and
    ``torch_fn(params, *inputs)`` and the gradients of
    sum_i sum(out_i * c_i) with respect to every parameter and float
    input."""
    rng = np.random.default_rng(seed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = [jnp.asarray(x) for x in inputs]
    float_in = [i for i, x in enumerate(inputs)
                if np.asarray(x).dtype == np.float32]

    def outs_of(p, xs):
        out = registry.apply(lambda: jax_fn(*xs), p, KEY)
        return out if isinstance(out, tuple) else (out,)

    xf = [jx[i] for i in float_in]

    def with_floats(xf):
        xs = list(jx)
        for i, x in zip(float_in, xf):
            xs[i] = x
        return xs

    # one compile each for the outputs and the gradients, at XLA's lowest
    # optimization level
    outs = compiled(jax.jit(lambda p, xf: outs_of(p, with_floats(xf))),
                    jp, xf)(jp, xf)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]

    def loss(p, xf):
        return sum(jnp.sum(o * c) for o, c in
                   zip(outs_of(p, with_floats(xf)), cots))

    gp, gx = compiled(jax.jit(jax.grad(loss, argnums=(0, 1))), jp, xf)(
        jp, xf)

    tp = {k: v.requires_grad_(True) for k, v in
          params_from_jax(params, "cpu").items()}
    tx = [torch.tensor(np.asarray(x)) for x in inputs]
    for i in float_in:
        tx[i].requires_grad_(True)
    tout = torch_fn(tp, *tx)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(tout) == len(outs) == n_out
    for k, (g, w) in enumerate(zip(tout, outs)):
        assert_close(g, w, f"output {k}")
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)
                if o.requires_grad)
    leaves = list(tp.values()) + [tx[i] for i in float_in]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for name, g in zip(tp, grads):
        want = np.asarray(gp[name])
        assert_close(torch.zeros_like(torch.from_numpy(want)) if g is None
                     else g, want, f"d/d{name}")
    for i, g in zip(float_in, grads[len(tp):]):
        assert_close(g, gx[float_in.index(i)], f"d/dinput{i}")


def randn(shape, seed=1, scale=1.0, shift=0.0):
    """f32 normal draws, scaled and shifted."""
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)
