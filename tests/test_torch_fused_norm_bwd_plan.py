"""K2c+K2d as one kernel (graphical_gan_tpu_torch/ops/kernels/fused_norm.py:
bn_bwd, csrc/fused_norm.cu: bn_bwd_fused_kernel) on the CPU: its plan, a
numpy emulation of the kernel's summation order run from the plan, and
bn_bwd's CPU path against the JAX ``_bwd``.

- The plan covers every row and channel exactly once, and its units (and
  so the order of every sum) depend on the shape alone. Its grid takes
  each unit once and no block more units than it has slots; with more
  than one row block, each block takes one unit.
- The emulation sums as the kernel does: per thread in row order, then a
  butterfly over the row lanes of a warp, then the warps in order; the
  partials merge in row-block order the same way (a plan with one row
  block takes its sums as they are). It equals the plain
  reduce within chip_smoke.py's RED_RTOL of each channel's mass (numpy
  has no fused multiply-add, the kernel has one per Σgz·xhat term).
- The on-chip / L2-reread choice at the cifar10 BN shapes, B 64 and 256:
  only G.BN3 at B=256 in f32 (65536 x 64, 32 MB of g and x) does not fit
  in the 132 blocks' shared memory.
- bn_bwd on the CPU against ``jax.grad`` of the JAX
  ``fused_batchnorm_act`` (the Pallas ``_bwd`` in interpret mode), with
  tests/test_torch_fused_norm_bwd.py's tolerances: f32 sums to atol
  1e-4·sqrt(R) and rtol 1e-4, dx to atol 1e-4·max(1, max |dx|) and rtol
  1e-4 (the variance formulas differ); bf16 dx within 2e-2·max(1, max |dx|)
  (one bf16 rounding).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas import fused_batchnorm_act as jax_fused
from graphical_gan_tpu_torch.ops.kernels import fused_norm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
CIFAR = [(b, name, rc) for b in (64, 256)
         for name, rc, _ in chip_smoke.bn_shapes(b)]
# chip_smoke's edge shapes: ragged row blocks, C not a multiple of 4 or 8,
# C wider than the SMs' tiles, R under one unit, one L2-reread shape, and
# one with more units than SMs
EDGE = [(196, 16), (3, 5), (1000, 130), (7, 4100), (5, 16), (90000, 96),
        (9, 67590)]
SHAPES = sorted({rc for _, _, rc in CIFAR}) + EDGE


def _ids(rc):
    return "x".join(map(str, rc))


def _units(p, r, c):
    """(rb, ct, r0, r1, c0, c1) of every unit, in unit order."""
    return [(u // p.n_ct, u % p.n_ct, (u // p.n_ct) * p.rows,
             min((u // p.n_ct + 1) * p.rows, r), (u % p.n_ct) * p.ct,
             min((u % p.n_ct + 1) * p.ct, c)) for u in range(p.units)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", SHAPES, ids=_ids)
def test_plan_covers_every_element_once(rc, dtype):
    r, c = rc
    p = fused_norm.bn_bwd_plan(r, c, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    assert p.vec in (1, 16 // size) and (p.vec == 1 or c % p.vec == 0)
    assert p.tx & (p.tx - 1) == 0
    assert p.tx * p.ty == (256 if p.vec == 8 else 512)  # threads per block
    assert p.ct == p.tx * p.vec and p.rows % p.ty == 0
    assert p.units == p.n_rb * p.n_ct and p.grid == min(p.units, 132)
    assert 0 <= p.cache_rows <= p.rows and p.smem <= 232448
    assert p.onchip == (p.cache_rows == p.rows)
    count = np.zeros((r, c), np.int8)
    for _, _, r0, r1, c0, c1 in _units(p, r, c):
        assert r0 < r1 and c0 < c1  # no empty unit
        count[r0:r1, c0:c1] += 1
    assert (count == 1).all()
    # block b takes units b, b + grid, ...: every unit once, at most
    # `slots` a block, and one a block where phase 2 merges row blocks
    taken = [list(range(b, p.units, p.grid)) for b in range(p.grid)]
    assert sorted(sum(taken, [])) == list(range(p.units))
    assert max(map(len, taken)) == p.slots
    assert p.n_rb == 1 or p.slots == 1


@pytest.mark.parametrize("rc", SHAPES, ids=_ids)
def test_plan_depends_on_the_shape_alone(rc):
    fused_norm.bn_bwd_plan.cache_clear()
    first = [fused_norm.bn_bwd_plan(*rc, dt) for dt in DTYPES]
    fused_norm.bn_bwd_plan.cache_clear()
    assert [fused_norm.bn_bwd_plan(*rc, dt) for dt in DTYPES] == first
    # unaligned pointers take the scalar path, also a function of the shape
    assert fused_norm.bn_bwd_plan(*rc, torch.float32, False).vec == 1


def _block_sum(vals, tx, ty):
    """The kernel's order for the sum over axis 0 of ``vals`` [n, w] (f32)
    in a block of tx x ty threads: row i goes to row lane i % ty and each
    lane adds its rows in order; then a butterfly over the row lanes of
    each warp (offsets 16 down to tx in lanes, i.e. 16/tx down to 1 in row
    lanes), then the warps' totals in warp order."""
    wy = 32 // tx if tx < 32 else 1
    n, w = vals.shape
    k = -(-n // ty)
    lanes = np.zeros((k * ty, w), np.float32)
    lanes[:n] = vals
    lanes = lanes.reshape(k, ty, w)
    acc = np.zeros((ty, w), np.float32)
    for i in range(k):
        acc = acc + lanes[i]
    acc = acc.reshape(ty // wy, wy, w)
    off = wy // 2
    while off >= 1:
        acc = acc + acc[:, np.arange(wy) ^ off]
        off //= 2
    total = acc[0, 0]
    for q in range(1, ty // wy):
        total = total + acc[q, 0]
    return total


def _emulate_red(g, x, mean, inv, scale, offset, act, p):
    """[Σgz, Σgz·xhat] as bn_bwd_fused_kernel sums them, from plan ``p``."""
    r, c = x.shape
    d = x - mean
    y = d * (inv * scale) + offset
    slope = {None: np.ones_like(y), "relu": (y > 0).astype(np.float32),
             "leaky_relu": np.where(y > 0, 1.0, 0.2).astype(np.float32)}
    gz = g * slope[act]
    terms = np.stack([gz, gz * (d * inv)], axis=1)  # [R, 2, C]
    part = np.zeros((p.n_rb, 2, c), np.float32)
    for rb, _, r0, r1, c0, c1 in _units(p, r, c):
        blk = terms[r0:r1, :, c0:c1].reshape(r1 - r0, -1)
        part[rb, :, c0:c1] = _block_sum(blk, p.tx, p.ty).reshape(2, c1 - c0)
    if p.n_rb == 1:  # the kernel takes the one row block's sums as they are
        return part[0], (gz, gz * (d * inv))
    red = np.zeros((2, c), np.float32)
    for ct in range(p.n_ct):
        c0, c1 = ct * p.ct, min((ct + 1) * p.ct, c)
        blk = part[:, :, c0:c1].reshape(p.n_rb, -1)
        red[:, c0:c1] = _block_sum(blk, p.tx, p.ty).reshape(2, c1 - c0)
    return red, (gz, gz * (d * inv))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("rc", [(1024, 256), (64, 4096), (16384, 64),
                                (1000, 130), (3, 5), (7, 4100)], ids=_ids)
def test_emulated_kernel_sums_match_the_plain_reduce(rc, act, dtype):
    """In bf16 the inputs are bf16 values and the arithmetic f32, on both
    sides; the plan (8 channels a thread, 256 threads) is bf16's."""
    rng = np.random.RandomState(rc[0] + rc[1])
    r, c = rc

    def cast(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).float(
            ).numpy()

    x = cast(rng.randn(r, c) * 2 + 0.5)
    g = cast(x * rng.randn(c) + rng.randn(r, c))
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    offset = rng.randn(c).astype(np.float32)
    xt = torch.from_numpy(x)
    mean, _, inv = fused_norm.bn_stats_plain(xt)
    want = fused_norm.bn_bwd_reduce_plain(
        torch.from_numpy(g), xt, mean, inv, torch.from_numpy(scale),
        torch.from_numpy(offset), act).numpy()
    p = fused_norm.bn_bwd_plan(r, c, dtype)
    got, (gz, gzx) = _emulate_red(g, x, mean.numpy(), inv.numpy(), scale,
                                  offset, act, p)
    mass = np.stack([np.abs(gz).sum(0), np.abs(gzx).sum(0)])
    assert (np.abs(got - want) <= chip_smoke.RED_RTOL * mass + 1e-6).all()


def test_onchip_choice_at_the_cifar10_shapes():
    """g and x stay in shared memory except at B=256 G.BN3 in f32."""
    got = {(b, name, str(dt)): fused_norm.bn_bwd_plan(*rc, dt).onchip
           for b, name, rc in CIFAR for dt in DTYPES}
    assert len(got) == 20
    assert [k for k, v in got.items() if not v] == [
        (256, "G.BN3", "torch.float32")]
    # the reread shape keeps most of each unit; the others keep all of it
    p = fused_norm.bn_bwd_plan(65536, 64, torch.float32)
    assert 0 < p.cache_rows < p.rows and p.smem > 200 * 1024


# bn_bwd's CPU path against the JAX custom VJP


def _inputs(shape):
    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype("float32")
    g = rng.randn(*shape).astype("float32")
    scale = (rng.rand(c) + 0.5).astype("float32")
    offset = (rng.randn(c) * 0.5).astype("float32")
    return x, g, scale, offset


@functools.lru_cache(maxsize=None)
def _jax_grads(shape, act, dtype):
    x, g, scale, offset = _inputs(shape)

    def loss(xx, s, o):
        y = jax_fused(xx, s, o, act).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(g))

    dx, ds, do = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(offset))
    return (np.asarray(dx.astype(jnp.float32)), np.asarray(ds),
            np.asarray(do))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(2, 5, 13, 24), (5, 7)], ids=_ids)
def test_bn_bwd_cpu_matches_pallas_bwd(shape, act, dtype):
    x, g, scale, offset = _inputs(shape)
    dx_ref, ds_ref, do_ref = _jax_grads(shape, act, dtype)
    c = shape[-1]
    tdt = getattr(torch, dtype)
    x2d = torch.from_numpy(x).to(tdt).reshape(-1, c)
    g2d = torch.from_numpy(g).to(tdt).reshape(-1, c)
    mean, _, inv = fused_norm.bn_stats(x2d)
    before = fused_norm.bn_bwd.launches
    dx, red = fused_norm.bn_bwd(g2d, x2d, mean, inv, torch.from_numpy(scale),
                                torch.from_numpy(offset), act)
    assert fused_norm.bn_bwd.launches == before  # the plain path
    assert red.shape == (2, c) and red.dtype == torch.float32
    assert dx.dtype == tdt and dx.shape == x2d.shape
    rows = x2d.shape[0]
    np.testing.assert_allclose(red[0].numpy(), do_ref,
                               atol=1e-4 * np.sqrt(rows), rtol=1e-4)
    np.testing.assert_allclose(red[1].numpy(), ds_ref,
                               atol=1e-4 * np.sqrt(rows), rtol=1e-4)
    got = dx.float().reshape(shape).numpy()
    size = max(1.0, float(np.abs(dx_ref).max()))
    if dtype == "bfloat16":
        assert float(np.abs(got - dx_ref).max()) <= 2e-2 * size
    else:
        np.testing.assert_allclose(got, dx_ref, atol=1e-4 * size, rtol=1e-4)
