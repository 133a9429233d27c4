"""The BN + activation backward differentiated once more
(``graphical_gan_tpu_torch/ops/kernels/fused_norm.py: FusedBatchNormAct``,
whose backward is K2c/K2d and whose second-order term is plain PyTorch)
against JAX differentiating its ``jnp`` BN twice (``graphical_gan_tpu/ops/
norm.py: batchnorm_act``, Pallas off, as the JAX package's default path
does), on the CPU; and the mnist wali-gp penalty, which runs D's two BNs
inside a double backward, against JAX's.

The second-order function: h(x, s, o) = Σ gx² + Σ gs·ws + Σ go·wo with
(gx, gs, go) the gradient of Σ c·act(bn(x)) and ws, wo fixed weights, so
the gradients of all three first-order outputs are exercised. Tolerance:
f32 sums in other orders through the statistics, atol 1e-4 scaled by
max(1, max |ref|) per output.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.ops.norm import batchnorm_act as jax_bn_act
from graphical_gan_tpu_torch.ops.kernels.fused_norm import (
    bn_act_backward_plain, fused_batchnorm_act)

from _torch_family1 import close, close_grads, models, raw_batch

SHAPES = {"D.BN2": (4, 7, 7, 16), "D.BN3": (4, 4, 4, 32),
          "dense": (6, 32)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 1.5 + 0.3
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    offset = rng.standard_normal(c).astype(np.float32) * 0.2
    cot = rng.standard_normal(shape).astype(np.float32)
    ws = rng.standard_normal(c).astype(np.float32)
    wo = rng.standard_normal(c).astype(np.float32)
    return x, scale, offset, cot, ws, wo


def _jax_second_order(x, scale, offset, cot, ws, wo, act):
    def first(xv, s, o):
        y = registry.apply(lambda: jax_bn_act("BN", xv, act),
                           {"BN.scale": s, "BN.offset": o}, None)
        return jnp.sum(jnp.asarray(cot) * y)

    def h(xv, s, o):
        gx, gs, go = jax.grad(first, (0, 1, 2))(xv, s, o)
        return jnp.sum(gx ** 2) + jnp.sum(gs * ws) + jnp.sum(go * wo)

    args = tuple(jnp.asarray(a) for a in (x, scale, offset))
    return jax.jit(jax.value_and_grad(h, (0, 1, 2)))(*args)


def _port_second_order(x, scale, offset, cot, ws, wo, act):
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, offset)]
    y = fused_batchnorm_act(*leaves, act)
    gx, gs, go = torch.autograd.grad((torch.from_numpy(cot) * y).sum(),
                                     leaves, create_graph=True)
    h = gx.square().sum() + (gs * torch.from_numpy(ws)).sum() \
        + (go * torch.from_numpy(wo)).sum()
    # offset reaches h only through act's mask, which is piecewise
    # constant: no gradient, as JAX's zeros
    grads = torch.autograd.grad(h, leaves, allow_unused=True)
    return h, [torch.zeros_like(t) if g is None else g
               for g, t in zip(grads, leaves)]


@pytest.mark.parametrize("act", ["leaky_relu", "relu", None])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_second_order_matches_jax(shape, act):
    args = _inputs(SHAPES[shape], seed=len(shape) + (act or "x").count("l"))
    want_h, want = _jax_second_order(*args, act)
    got_h, got = _port_second_order(*args, act)
    close(got_h, want_h)
    for g, w in zip(got, want):
        close(g, w)


def test_plain_backward_is_the_kernels_function():
    """bn_act_backward_plain (the function the second order
    differentiates) equals the first-order backward (K2c/K2d's plain
    versions on the CPU) at atol 1e-5."""
    x, scale, offset, cot, _, _ = _inputs(SHAPES["D.BN2"], seed=5)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, offset)]
    y = fused_batchnorm_act(*leaves, "leaky_relu")
    first = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    plain = bn_act_backward_plain(torch.from_numpy(cot), *[
        torch.from_numpy(a) for a in (x, scale, offset)], "leaky_relu")
    for a, b in zip(first, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_third_order_raises():
    x, scale, offset, cot, ws, wo = _inputs(SHAPES["dense"], seed=2)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, offset)]
    y = fused_batchnorm_act(*leaves, "relu")
    (gx,) = torch.autograd.grad((torch.from_numpy(cot) * y).sum(),
                                leaves[0], create_graph=True)
    (g2,) = torch.autograd.grad(gx.square().sum(), leaves[0],
                                create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g2.sum(), leaves[0])


def test_mnist_penalty_parameter_gradient_matches_jax():
    """wali-gp's penalty on mnist (BN2 and BN3 inside D) and its gradient
    w.r.t. every D parameter; inputs and alpha from numpy. Gradients per
    ``close_grads`` (1e-4 of max(1e-2, the leaf's, 1e-2 of D's largest))."""
    from graphical_gan_tpu.models import networks as jax_nets
    from graphical_gan_tpu.objectives import penalties as jax_pen
    from graphical_gan_tpu_torch.core.registry import partition
    from graphical_gan_tpu_torch.models import networks
    from graphical_gan_tpu_torch.objectives import penalties
    jm, tm, jp, tp = models("mnist", "wali-gp")
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    real = raw_batch(cfg, rng)
    fake = rng.random(real.shape, dtype=np.float32)
    q_z = rng.standard_normal((cfg.batch_size, cfg.dim_latent), np.float32)
    p_z = rng.standard_normal(q_z.shape, np.float32)
    key = jax.random.PRNGKey(4)
    alpha = np.asarray(jax.random.uniform(key, (cfg.batch_size, 1)))
    j_disc, j_rest = registry.partition(jp, jm.DISC_PLAYER)

    def jax_gp(pd):
        return registry.apply(lambda: jax_pen.gradient_penalty_xz(
            lambda x, z: jax_nets.discriminator_xz(jm.cfg, x, z),
            jnp.asarray(real), jnp.asarray(fake), jnp.asarray(q_z),
            jnp.asarray(p_z), key, cfg.gp_lambda),
            registry.merge(pd, j_rest), None)

    want_gp, want = jax.jit(jax.value_and_grad(jax_gp))(j_disc)
    disc, _ = partition(tp, tm.DISC_PLAYER)
    leaves = {n: p.clone().requires_grad_(True) for n, p in disc.items()}
    merged = dict(tp, **leaves)
    gp = penalties.gradient_penalty_xz(
        lambda x, z: networks.discriminator_xz(cfg, merged, x, z),
        *[torch.tensor(a) for a in (real, fake, q_z, p_z, alpha)],
        cfg.gp_lambda)
    # the output bias does not reach D's input gradient: JAX's zeros
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad(gp, list(leaves.values()), allow_unused=True),
        leaves.values())]
    close(gp, want_gp)
    close_grads(dict(zip(leaves, grads)), want)
