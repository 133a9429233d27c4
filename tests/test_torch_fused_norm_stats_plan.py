"""K2a as one kernel (graphical_gan_tpu_torch/ops/kernels/fused_norm.py:
bn_stats, csrc/fused_norm.cu: bn_stats_fused_kernel) on the CPU: its plan,
and a torch emulation of the kernel's order run from the plan.

- The plan covers every row and channel exactly once, depends on the shape
  alone, and takes its units from the tiling K2c+K2d's plan uses.
- The emulation computes as the kernel does: per unit, d = x - x[0, c]
  and d² summed per thread in row order in f64, a fixed-order block sum (a
  butterfly over the row lanes of a warp, then the warps in order), the
  unit's (mean, M2) of d; then the units' partials merge per channel in
  row-block order by Chan's formula in f64, weighted by each row block's
  rows (a plan with one row block takes its unit's sums as they are); mean
  and var rounded once to f32, inv in f32. It matches ``bn_stats_plain``,
  the JAX ``_stats`` (the Pallas kernel, run in interpret mode on the CPU)
  and ``jnp.mean`` / ``jnp.var`` within atol 1e-5 and rtol 1e-4 (the
  references are f32 sums in other orders), and the f32 rounding of an f64
  reference up to one f32 step (torch has no fused multiply-add for the
  d² terms; the kernel has one per term).
- At a mean of 1e3 against a spread of 2 the emulated variance stays
  within 1e-4 relative of an f64 variance (a sum of squares in f32 would
  lose most of its digits there).

In bf16 the inputs are bf16 values, held as f32, on both sides; the plan
(8 channels a thread, 256 threads) is bf16's.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas.fused_norm import _stats as jax_stats
from graphical_gan_tpu_torch.ops.kernels import fused_norm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
DTYPES = [torch.float32, torch.bfloat16]
CIFAR = [(b, name, rc) for b in (8, 64, 256)
         for name, rc, _ in chip_smoke.bn_shapes(b)]
# one row, one channel; C not a multiple of 4 or 8; a shape whose x does
# not all fit in shared memory in f32; one with more units than SMs
EDGE = [(3, 5), (1, 1), (90000, 96), (9, 67590)]
SHAPES = sorted({rc for _, _, rc in CIFAR}) + EDGE


def _ids(rc):
    return "x".join(map(str, rc))


def _units(p, r, c):
    """(rb, r0, r1, c0, c1) of every unit, in unit order."""
    return [(u // p.n_ct, (u // p.n_ct) * p.rows,
             min((u // p.n_ct + 1) * p.rows, r), (u % p.n_ct) * p.ct,
             min((u % p.n_ct + 1) * p.ct, c)) for u in range(p.units)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", SHAPES, ids=_ids)
def test_plan_covers_every_element_once(rc, dtype):
    r, c = rc
    p = fused_norm.bn_stats_plan(r, c, dtype)
    assert p.vec in (1, 16 // dtype.itemsize)
    assert p.vec == 1 or c % p.vec == 0
    assert p.tx & (p.tx - 1) == 0
    assert p.tx * p.ty == (256 if p.vec == 8 else 512)  # threads per block
    assert p.ct == p.tx * p.vec and p.rows % p.ty == 0
    assert p.units == p.n_rb * p.n_ct and p.grid == min(p.units, 132)
    assert p.cache_rows == 0 and not p.onchip  # K2a keeps no rows
    assert 0 < p.smem <= 232448
    count = np.zeros((r, c), np.int8)
    for _, r0, r1, c0, c1 in _units(p, r, c):
        assert r0 < r1 and c0 < c1  # no empty unit
        count[r0:r1, c0:c1] += 1
    assert (count == 1).all()
    # block b takes units b, b + grid, ...: every unit once; where the
    # partials merge after the barrier, one unit a block
    taken = [list(range(b, p.units, p.grid)) for b in range(p.grid)]
    assert sorted(sum(taken, [])) == list(range(p.units))
    assert max(map(len, taken)) == p.slots
    assert p.n_rb == 1 or p.grid == p.units
    # the merge stages a tile's partials with one channel a thread
    assert p.n_rb == 1 or (p.tx * p.ty) % p.ct == 0


@pytest.mark.parametrize("rc", SHAPES, ids=_ids)
def test_plan_depends_on_the_shape_alone(rc):
    fused_norm.bn_stats_plan.cache_clear()
    first = [fused_norm.bn_stats_plan(*rc, dt) for dt in DTYPES]
    fused_norm.bn_stats_plan.cache_clear()
    assert [fused_norm.bn_stats_plan(*rc, dt) for dt in DTYPES] == first
    # an unaligned x takes the scalar path, also a function of the shape
    assert fused_norm.bn_stats_plan(*rc, torch.float32, False).vec == 1


@pytest.mark.parametrize("rc", SHAPES, ids=_ids)
def test_plan_takes_the_backward_units(rc):
    """K2a and K2c+K2d cut [R, C] alike."""
    for dt in DTYPES:
        for aligned in (True, False):
            s = fused_norm.bn_stats_plan(*rc, dt, aligned)
            b = fused_norm.bn_bwd_plan(*rc, dt, aligned)
            shared = ("vec", "tx", "ty", "ct", "n_ct", "rows", "n_rb",
                      "units", "grid", "slots")
            assert [getattr(s, k) for k in shared] == [
                getattr(b, k) for k in shared]


def test_shared_memory_at_the_cifar10_shapes():
    """K2a's shared memory holds its f64 block sums and staged partials
    only: under the 48 KB a block gets without opting in, at every cifar10
    BN shape, B 8, 64 and 256, in both dtypes; the most is bf16 G.BN3 at
    B 64 and 256 (64 row blocks of 32 channels)."""
    smem = {(rc, dt): fused_norm.bn_stats_plan(*rc, dt).smem
            for _, _, rc in CIFAR for dt in DTYPES}
    assert max(smem.values()) < 48 * 1024
    assert smem[(65536, 64), torch.bfloat16] == max(smem.values())


def _block_sum(vals, tx, ty):
    """The kernel's order for the sum over axis 0 of ``vals`` [n, w] (f32)
    in a block of tx x ty threads: row i goes to row lane i % ty and each
    lane adds its rows in order; then a butterfly over the row lanes of
    each warp (offsets 16 down to tx in lanes, i.e. 16/tx down to 1 in row
    lanes), then the warps' totals in warp order. The order is the same in
    every channel tile, so ``vals`` may hold a whole row block."""
    wy = 32 // tx if tx < 32 else 1
    n, w = vals.shape
    k = -(-n // ty)
    lanes = torch.zeros((k * ty, w), dtype=vals.dtype)
    lanes[:n] = vals
    lanes = lanes.reshape(k, ty, w)
    acc = torch.zeros((ty, w), dtype=vals.dtype)
    for i in range(k):
        acc = acc + lanes[i]
    acc = acc.reshape(ty // wy, wy, w)
    off = wy // 2
    while off >= 1:
        acc = acc + acc[:, torch.arange(wy) ^ off]
        off //= 2
    total = acc[0, 0]
    for q in range(1, ty // wy):
        total = total + acc[q, 0]
    return total


def _emulate(x, p, eps=fused_norm.EPS):
    """(mean, var, inv) of f32 x [R, C] as bn_stats_fused_kernel computes
    them from plan ``p``."""
    r, c = x.shape
    shift = x[0].double()
    d = x.double() - shift  # exact in f64
    part = []
    for rb in range(p.n_rb):
        blk = d[rb * p.rows:min((rb + 1) * p.rows, r)]
        sd = _block_sum(blk, p.tx, p.ty)
        mean_d = sd / blk.shape[0]
        m2 = (_block_sum(blk * blk, p.tx, p.ty) - sd * mean_d).clamp_min(0)
        part.append((mean_d, m2))
    mean_d, m2 = part[0]
    for q, (mb, m2b) in enumerate(part[1:], 1):  # Chan, in row-block order
        na = float(q * p.rows)
        nb = float(min(p.rows, r - q * p.rows))
        fb = nb / (na + nb)
        delta = mb - mean_d
        mean_d = mean_d + delta * fb
        m2 = m2 + m2b + delta * delta * (na * fb)
    var = (m2 / r).float()
    return (shift + mean_d).float(), var, 1.0 / torch.sqrt(var + eps)


def _x(rc, dtype, loc, seed):
    """Inputs of the working dtype, as f32 values."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*rc) * 2 + loc).astype(np.float32)
    return torch.from_numpy(x).to(dtype).float()


EMULATED = sorted({rc for _, _, rc in CIFAR[:10]}) + [
    (3, 5), (1, 1), (196, 16), (1000, 130), (7, 4100), (9, 67590)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", EMULATED, ids=_ids)
def test_emulated_kernel_order_matches_the_references(rc, dtype):
    x = _x(rc, dtype, 0.5, sum(rc))
    mean, var, inv = _emulate(x, fused_norm.bn_stats_plan(*rc, dtype))
    pm, pv, pinv = fused_norm.bn_stats_plain(x)
    for got, want in ((mean, pm), (var, pv), (inv, pinv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
    x64 = x.double()
    for got, want in ((mean, x64.mean(0)), (var, x64.var(0, unbiased=False))):
        exact = want.float()
        step = (torch.nextafter(exact, exact + exact.abs() + 1) - exact).abs()
        assert bool(((got - exact).abs() <= step).all())
    xj = jnp.asarray(x.numpy())
    jm, jv = jax_stats(xj)  # the Pallas kernel, interpret mode on the CPU
    for got, want in ((mean, jm), (var, jv), (mean, jnp.mean(xj, axis=0)),
                      (var, jnp.var(xj, axis=0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", [(4096, 128), (1024, 256), (64, 4096),
                                (16384, 64), (90000, 96)], ids=_ids)
def test_emulated_variance_at_a_large_mean(rc, dtype):
    x = _x(rc, dtype, 1e3, sum(rc) + 1)
    _, var, _ = _emulate(x, fused_norm.bn_stats_plan(*rc, dtype))
    v64 = x.double().var(dim=0, unbiased=False)
    assert float(((var.double() - v64).abs() / v64).max()) <= RTOL
