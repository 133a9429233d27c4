"""The split BN forward (``graphical_gan_tpu_torch/ops/kernels/
fused_norm.py``: K2a's split mode with K2b's, ``csrc/fused_norm.cu:
bn_stats_local_kernel``, ``bn_apply_split_kernel``) on the CPU.

- ``bn_stats_local_plan`` covers every row of every channel once, with no
  empty block and a cluster of at most 16, its shared memory within the
  227 KB a block may opt into, at the cifar10 BN shapes at a rank's rows
  for 1, 2 and 4 ranks and batches 8, 64 and 256, and at ragged shapes;
  it depends on the shape alone. ``bn_apply_split_plan`` covers every
  element once, and its blocks read the ranks' triples again at most a
  tenth of x's bytes.
- An emulation of the kernel's order (per block the K2a unit's sums, f64,
  a fixed-order block sum; the blocks merged in block order by Chan's
  formula with the plan's weights; the shift added back) matches
  ``bn_stats_local_plain`` within 1e-9 of 1 + |value| at a mean of 1e3.
- On 2 and 3 gloo ranks the slot form through ``all_reduce_stack`` gives
  ``gather_stack``'s bits.
- ``bn_apply_split_plain`` and its int8 form are ``bn_stats_merge_plain``
  followed by ``bn_apply_plain`` / ``bn_apply_q8_plain`` bit for bit, for
  1-4 ranks of unequal rows, the three activations, f32 and bf16; so a
  CPU run of the split forward gives the bits of the chain it replaced.
- ``tools/sweep_stats_local.py``'s candidates are valid plans; the tool
  refuses to measure without a card.
- Against JAX: ``graphical_gan_tpu.ops.pallas.fused_batchnorm_act`` (the
  Pallas kernels in interpret mode on the CPU) over the concatenated rows
  against the port's ``fused_batchnorm_act(..., group=)`` on 2 and 4 gloo
  ranks of 3 x 8 rows of 16 channels each: y and dx per rank, dscale and
  doffset summed over the ranks, within 1e-5 of the largest reference
  value (f32 sums in other orders on the two sides).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import _torch_dist
from graphical_gan_tpu.ops.pallas import fused_batchnorm_act as jax_bn_act
from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
from graphical_gan_tpu_torch.tools import sweep_stats_local as sweep_tool
from test_torch_fused_norm_stats_plan import CIFAR, _block_sum
from _torch_threads import one_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
ACTS = [None, "relu", "leaky_relu"]
SMEM_MAX = 232448
# a rank's rows of every cifar10 BN shape at B 8, 64, 256 over 1, 2, 4
# ranks, then ragged shapes: one row, C not a multiple of 4 or 8, rows
# past a full cluster, more channel tiles than SMs
RANK_SHAPES = sorted({(r // w, c) for _, _, (r, c) in CIFAR
                      for w in (1, 2, 4)})
RAGGED = [(1, 1), (3, 5), (7, 130), (1000, 67), (90001, 96), (9, 67590)]


def _ids(rc):
    return "x".join(map(str, rc))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", RANK_SHAPES + RAGGED, ids=_ids)
def test_local_plan_covers_every_row_once(rc, dtype):
    r, c = rc
    for aligned in (True, False):
        p = fn.bn_stats_local_plan(r, c, dtype, aligned)
        assert p.vec in (1, 16 // dtype.itemsize)
        assert p.vec == 1 or c % p.vec == 0
        assert p.tx & (p.tx - 1) == 0
        assert p.tx * p.ty == (256 if p.vec == 8 else 512)
        assert p.ct == p.tx * p.vec and p.rows % p.ty == 0
        assert 1 <= p.cluster <= 16
        # every row once, no empty block; every channel in one tile
        assert p.rows * (p.cluster - 1) < r <= p.rows * p.cluster
        assert p.ct * (p.n_ct - 1) < c <= p.ct * p.n_ct
        groups = p.ty // (32 // p.tx if p.tx < 32 else 1)
        assert p.smem == ((groups + 1) * 2 * p.ct + p.cluster * 2 * p.ct
                          + p.ct + 2 * p.cluster) * 8
        assert 0 < p.smem <= SMEM_MAX
        # the tiles are the one-launch K2a's
        u = fn.bn_stats_plan(r, c, dtype, aligned)
        assert (p.vec, p.tx, p.ct, p.n_ct) == (u.vec, u.tx, u.ct, u.n_ct)
    fn.bn_stats_local_plan.cache_clear()
    first = fn.bn_stats_local_plan(r, c, dtype)
    fn.bn_stats_local_plan.cache_clear()
    assert fn.bn_stats_local_plan(r, c, dtype) == first


def test_local_plan_cluster_sizes():
    """G.BN1's 32 rows a rank take one block; G.BN3's 8,192 rows of 64
    channels fill a cluster of 8 (16 at the sweep's limit of 16); no
    shape gives more than one block an SM over its clusters."""
    assert fn.bn_stats_local_plan(32, 4096, torch.float32).cluster == 1
    p = fn.bn_stats_local_plan(8192, 64, torch.float32)
    assert p.cluster == 8
    threads = p.tx * p.ty
    assert fn.local_plan_at(8192, 64, p.vec, p.tx, threads, 8) == p
    assert fn.local_plan_at(8192, 64, p.vec, p.tx, threads,
                            16).cluster == 16
    for r, c in RANK_SHAPES:
        for dt in DTYPES:
            p = fn.bn_stats_local_plan(r, c, dt)
            assert p.cluster == 1 or p.n_ct * p.cluster <= 132


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", RANK_SHAPES + RAGGED, ids=_ids)
def test_apply_plan_covers_every_element_once(rc, dtype, world):
    r, c = rc
    for aligned in (True, False):
        p = fn.bn_apply_split_plan(r, c, dtype, world, aligned)
        assert p.vec in (1, 16 // dtype.itemsize)
        assert p.vec == 1 or c % p.vec == 0
        assert p.tx & (p.tx - 1) == 0 and p.tx * p.ty == 256
        assert p.ct == p.tx * p.vec and p.rows % p.ty == 0
        assert p.rows * (p.n_rr - 1) < r <= p.rows * p.n_rr
        assert p.ct * (p.n_ct - 1) < c <= p.ct * p.n_ct
        assert 1 <= p.n_rr <= 65535
        assert p.smem == 3 * p.ct * 4 <= 48 * 1024
        # the triples each block reads past the first: under a tenth of x
        extra = (p.n_rr - 1) * world * 3 * c * 8
        assert p.n_rr == 1 or 10 * extra < r * c * dtype.itemsize


def _emulate_local(x, p):
    """[3, C] f64 (n, mean, M2) of f32 x [R, C] as bn_stats_local_kernel
    computes them from plan ``p``."""
    r, _ = x.shape
    shift = x[0].double()
    d = x.double() - shift  # exact in f64
    mine = []
    for b in range(p.cluster):
        blk = d[b * p.rows:min((b + 1) * p.rows, r)]
        sd = _block_sum(blk, p.tx, p.ty)
        mean_d = sd / blk.shape[0]
        m2 = (_block_sum(blk * blk, p.tx, p.ty) - sd * mean_d).clamp_min(0)
        mine.append((mean_d, m2))
    mean_d, m2 = mine[0]
    for b, (mb, m2b) in enumerate(mine[1:], 1):  # Chan, in block order
        na = float(b * p.rows)
        nb = float(min(p.rows, r - b * p.rows))
        fb = nb / (na + nb)
        delta = mb - mean_d
        mean_d = mean_d + delta * fb
        m2 = m2 + m2b + delta * delta * (na * fb)
    return torch.stack([torch.full_like(m2, float(r)), shift + mean_d, m2])


EMULATED = [(2048, 128), (512, 256), (32, 4096), (8192, 64), (256, 256),
            (3, 5), (1000, 67), (4097, 16)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", EMULATED, ids=_ids)
def test_emulated_kernel_order_matches_the_plain_version(rc, dtype):
    rng = np.random.RandomState(sum(rc))
    x = torch.from_numpy((rng.randn(*rc) * 2 + 1e3).astype(np.float32))
    x = x.to(dtype).float()
    got = _emulate_local(x, fn.bn_stats_local_plan(*rc, dtype))
    want = fn.bn_stats_local_plain(x)
    assert float(((got - want).abs() / (1.0 + want.abs())).max()) <= 1e-9


@pytest.mark.parametrize("index", [0, 2])
def test_slot_form_on_the_cpu(index):
    x = torch.from_numpy(np.random.RandomState(index).randn(
        6, 5).astype(np.float32))
    slot = fn.bn_stats_local(x, index, 3)
    assert slot.shape == (3, 3, 5) and slot.dtype == torch.float64
    assert torch.equal(slot[index], fn.bn_stats_local_plain(x))
    others = torch.cat([slot[:index], slot[index + 1:]])
    assert bool((others.view(torch.int64) == 0).all())  # +0.0, not -0.0
    one = fn.bn_stats_local(x, 0, 1)
    assert one.shape == (1, 3, 5)
    assert torch.equal(one[0], fn.bn_stats_local_plain(x))


def _parts(rng, rows, c, dtype):
    xs = [torch.from_numpy((rng.standard_normal((n, c)) * 2 + 5).astype(
        np.float32)).to(dtype) for n in rows]
    w = len(xs)
    parts = sum(fn.bn_stats_local_plain(p, i, w) for i, p in enumerate(xs))
    return xs, parts


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("rows", [(9,), (6, 6), (4, 11, 2), (5, 1, 9, 3)],
                         ids=lambda r: f"W{len(r)}")
def test_apply_split_is_the_merge_then_the_apply(rows, act, dtype):
    rng = np.random.default_rng(len(rows) * 7 + ACTS.index(act))
    c = 12
    xs, parts = _parts(rng, rows, c, dtype)
    # the slot form summed is the triples stacked
    stacked = torch.stack([fn.bn_stats_local_plain(p) for p in xs])
    assert torch.equal(parts.view(torch.int64), stacked.view(torch.int64))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    offset = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    stats = fn.bn_stats_merge_plain(parts)
    s_x = 0.05
    for p in xs:
        want_y = fn.bn_apply_plain(p, stats[0], stats[2], scale, offset, act)
        y, st = fn.bn_apply_split(p, parts, scale, offset, act)
        assert torch.equal(st, stats) and torch.equal(y, want_y)
        assert y.dtype == dtype
        want_yq, want_q = fn.bn_apply_q8_plain(p, stats[0], stats[2], scale,
                                               offset, act, s_x)
        yq, q, st = fn.bn_apply_split_q8(p, parts, scale, offset, act, s_x)
        assert torch.equal(st, stats) and torch.equal(yq, want_yq)
        assert torch.equal(q, want_q) and q.dtype == torch.int8


@pytest.fixture(scope="module")
def ranks():
    """Per world size, (payload, each rank's result) of
    ``_torch_dist.bn_split_fwd_worker``: the exchange's bits on 2 and 3
    ranks, the BN cases on 2 and 4."""
    jobs = {}
    for world in (2, 3, 4):
        rng = np.random.default_rng(60 + world)
        cases = []
        if world != 3:
            for act in ACTS:
                shape = (3 * world, 8, 16)
                cases.append(dict(
                    x=(rng.standard_normal(shape) * 2 + 3).astype(
                        np.float32),
                    gy=rng.standard_normal(shape).astype(np.float32),
                    v=rng.standard_normal(shape).astype(np.float32),
                    scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                    offset=(0.1 * rng.standard_normal(16)).astype(
                        np.float32), act=act))
        x = (rng.standard_normal((5 * world, 7)) + 40.0).astype(np.float32)
        x[:, 3] = -0.0  # a mean of -0, +0 after either exchange
        payload = {"x": x, "cases": cases}
        jobs[world] = (payload, _torch_dist.start("bn_split_fwd_worker",
                                                  world, payload))
    return {w: (p, job.join()) for w, (p, job) in jobs.items()}


@pytest.mark.parametrize("world", [2, 3])
def test_slot_form_through_all_reduce_stack_is_gather_stack(ranks, world):
    _, results = ranks[world]
    for r in results:
        np.testing.assert_array_equal(r["slot"], r["stack"])
        np.testing.assert_array_equal(r["slot"], results[0]["slot"])


def _jax_reference(c):
    x = jnp.asarray(c["x"])
    y, vjp = jax.vjp(lambda x, s, o: jax_bn_act(x, s, o, c["act"]), x,
                     jnp.asarray(c["scale"]), jnp.asarray(c["offset"]))
    dx, dscale, doffset = vjp(jnp.asarray(c["gy"]))
    return {k: np.asarray(v) for k, v in dict(
        y=y, dx=dx, dscale=dscale, doffset=doffset).items()}


def _within(got, want, rtol=1e-5):
    """|got - want| <= rtol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("i", range(len(ACTS)), ids=[str(a) for a in ACTS])
@pytest.mark.parametrize("world", [2, 4])
def test_group_bn_matches_jax_over_the_whole_batch(ranks, world, i):
    payload, results = ranks[world]
    want = _jax_reference(payload["cases"][i])
    got = [r["bn"][i] for r in results]
    for key in ("y", "dx"):
        _within(np.concatenate([g[key] for g in got]), want[key])
    for key in ("dscale", "doffset"):
        _within(sum(g[key] for g in got), want[key])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", [s[0] for s in sweep_tool.SHAPES])
def test_sweep_candidates_are_valid_plans(name, dtype):
    """``tools/sweep_stats_local.py``: the chosen plan first, every
    candidate a plan of the same shape that covers its rows, none
    twice."""
    _, per, c = next(s for s in sweep_tool.SHAPES if s[0] == name)
    r = sweep_tool.B * per // 2
    cands = sweep_tool.candidates(fn, r, c, dtype)
    assert cands[0] == fn.bn_stats_local_plan(r, c, dtype)
    assert len(set(cands)) == len(cands) > 1
    for p in cands:
        assert 1 <= p.cluster <= 16
        assert p.tx * p.ty == cands[0].tx * cands[0].ty
        assert p.rows * (p.cluster - 1) < r <= p.rows * p.cluster


def test_sweep_needs_the_card():
    x = sweep_tool.inputs("G.BN1", torch.float32, "cpu")
    assert x.shape == (sweep_tool.B, 4096) and x.dtype == torch.float32
    with pytest.raises(RuntimeError):
        sweep_tool.sweep()
