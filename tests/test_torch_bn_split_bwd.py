"""The split BN backward (``graphical_gan_tpu_torch/ops/kernels/
fused_norm.py``: K2c+K2d's split mode, ``csrc/fused_norm.cu:
bn_bwd_local_kernel``, ``bn_bwd_apply_split_kernel``) on the CPU.

- ``bn_bwd_local_plan`` covers every row of every channel once, with no
  empty block and a cluster of at most 16, its shared memory within the
  227 KB a block may opt into, at the cifar10 BN shapes at a rank's rows
  for 1, 2 and 4 ranks and batches 8, 64 and 256, and at ragged shapes;
  it depends on the shape alone. ``bn_bwd_apply_split_plan`` covers every
  element once, and its blocks read the ranks' sums again at most a tenth
  of g's and x's bytes.
- An emulation of the kernel's order (per block the f32 sums of each
  thread's rows, a fixed-order block sum; the blocks added in block
  order) matches ``bn_bwd_reduce_plain`` within chip_smoke.py's RED_RTOL
  of each channel's mass.
- The slot form on the CPU: the plain sums in the rank's slot, +0 in the
  others.
- ``bn_bwd_apply_split_plain`` on the stacked slots is the rank-order sum
  (``sum_in_rank_order``'s loop) followed by ``bn_bwd_apply_plain`` bit
  for bit, for 1-4 ranks of unequal rows, the three activations, f32 and
  bf16; so a CPU run of the split backward gives the bits of the chain it
  replaced.
- On 2 and 3 gloo ranks the slot form through ``all_reduce_stack`` gives
  ``gather_stack``'s bits, and dx is ``sum_in_rank_order`` then
  ``bn_bwd_apply_plain`` bit for bit.
- With ``gather_stack`` and ``sum_in_rank_order`` patched to raise, a
  split BN backward on 2 gloo ranks makes exactly one ``all_reduce_stack``
  call, of the [2, 2, C] buffer.
- Against JAX: ``graphical_gan_tpu.ops.pallas.fused_batchnorm_act`` (the
  Pallas kernels in interpret mode on the CPU) over the concatenated rows
  against the port's ``fused_batchnorm_act(..., group=)`` on 2 and 4 gloo
  ranks of 3 x 8 rows of 16 channels each: dx per rank, dscale and
  doffset summed over the ranks, within 1e-5 of the largest reference
  value.
- ``tools/sweep_stats_local.py``'s ``bn_bwd_local`` candidates are
  valid plans.
"""

import numpy as np
import pytest
import torch

import _torch_dist
import chip_smoke
from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
from graphical_gan_tpu_torch.tools import sweep_stats_local as sweep_tool
from test_torch_bn_split_fwd import (RAGGED, RANK_SHAPES, _ids,
                                     _jax_reference, _within)
from test_torch_fused_norm_stats_plan import _block_sum
from _torch_threads import one_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
ACTS = [None, "relu", "leaky_relu"]
SMEM_MAX = 232448


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", RANK_SHAPES + RAGGED, ids=_ids)
def test_local_plan_covers_every_row_once(rc, dtype):
    r, c = rc
    for aligned in (True, False):
        p = fn.bn_bwd_local_plan(r, c, dtype, aligned)
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
        assert p.smem == (groups + 1 + p.cluster) * 2 * p.ct * 4
        assert 0 < p.smem <= SMEM_MAX
        # the tiles are the one-launch K2c+K2d's
        u = fn.bn_bwd_plan(r, c, dtype, aligned)
        assert (p.vec, p.tx, p.ct, p.n_ct) == (u.vec, u.tx, u.ct, u.n_ct)
        assert p.cluster == 1 or p.n_ct * p.cluster <= 132
    fn.bn_bwd_local_plan.cache_clear()
    first = fn.bn_bwd_local_plan(r, c, dtype)
    fn.bn_bwd_local_plan.cache_clear()
    assert fn.bn_bwd_local_plan(r, c, dtype) == first


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", RANK_SHAPES + RAGGED, ids=_ids)
def test_apply_plan_covers_every_element_once(rc, dtype, world):
    r, c = rc
    for aligned in (True, False):
        p = fn.bn_bwd_apply_split_plan(r, c, dtype, world, aligned)
        assert p.vec in (1, 16 // dtype.itemsize)
        assert p.vec == 1 or c % p.vec == 0
        assert p.tx & (p.tx - 1) == 0 and p.tx * p.ty == 256
        assert p.ct == p.tx * p.vec and p.rows % p.ty == 0
        assert p.rows * (p.n_rr - 1) < r <= p.rows * p.n_rr
        assert p.ct * (p.n_ct - 1) < c <= p.ct * p.n_ct
        assert 1 <= p.n_rr <= 65535
        assert p.smem == 5 * p.ct * 4 <= 48 * 1024
        # the sums each block reads past the first: under a tenth of g's
        # and x's bytes
        extra = (p.n_rr - 1) * world * 2 * c * 4
        assert p.n_rr == 1 or 10 * extra < 2 * r * c * dtype.itemsize


def _emulate_local(g, x, mean, inv, scale, offset, act, p):
    """[Σgz, Σgz·xhat] of f32 g, x [R, C] as bn_bwd_local_kernel sums them
    from plan ``p``, and each channel's mass [Σ|gz|, Σ|gz·xhat|]."""
    r, _ = x.shape
    gz, xhat = fn._gz_xhat(g, x, mean, inv, scale, offset, act)
    terms = torch.cat([gz, gz * xhat], dim=1)  # [R, 2C], f32
    total = None
    for b in range(p.cluster):  # the blocks added in block order
        blk = _block_sum(terms[b * p.rows:min((b + 1) * p.rows, r)],
                         p.tx, p.ty)
        total = blk if total is None else total + blk
    mass = torch.cat([gz.abs().sum(0), (gz * xhat).abs().sum(0)])
    return total.reshape(2, -1), mass.reshape(2, -1)


EMULATED = [(2048, 128), (512, 256), (32, 4096), (8192, 64), (256, 256),
            (3, 5), (1000, 67), (4097, 16)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rc", EMULATED, ids=_ids)
def test_emulated_kernel_order_matches_the_plain_version(rc, dtype, act):
    """In bf16 the inputs are bf16 values and the arithmetic f32, on both
    sides; the plan is bf16's."""
    rng = np.random.RandomState(sum(rc))
    r, c = rc
    x = torch.from_numpy((rng.randn(r, c) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(r, c).astype(np.float32))
    x, g = x.to(dtype).float(), g.to(dtype).float()
    scale = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32))
    offset = torch.from_numpy(rng.randn(c).astype(np.float32))
    mean, _, inv = fn.bn_stats_plain(x)
    got, mass = _emulate_local(g, x, mean, inv, scale, offset, act,
                               fn.bn_bwd_local_plan(r, c, dtype))
    want = fn.bn_bwd_reduce_plain(g, x, mean, inv, scale, offset, act)
    assert float(((got - want).abs() / (1.0 + mass)).max()) \
        <= chip_smoke.RED_RTOL


def _chan(rng, c):
    return (torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            torch.from_numpy((0.1 * rng.standard_normal(c)).astype(
                np.float32)))


@pytest.mark.parametrize("index", [0, 2])
def test_slot_form_on_the_cpu(index):
    rng = np.random.default_rng(index)
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    scale, offset = _chan(rng, 5)
    mean, _, inv = fn.bn_stats_plain(x)
    args = (g, x, mean, inv, scale, offset)
    slot = fn.bn_bwd_local(*args, index, 3, "relu")
    assert slot.shape == (3, 2, 5) and slot.dtype == torch.float32
    assert torch.equal(slot[index], fn.bn_bwd_reduce_plain(*args, "relu"))
    others = torch.cat([slot[:index], slot[index + 1:]])
    assert bool((others.view(torch.int32) == 0).all())  # +0.0, not -0.0
    one = fn.bn_bwd_local(*args, 0, 1)
    assert one.shape == (1, 2, 5)
    assert torch.equal(one[0], fn.bn_bwd_reduce_plain(*args))
    with pytest.raises(ValueError):
        fn.bn_bwd_local(*args, 3, 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("rows", [(9,), (6, 6), (4, 11, 2), (5, 1, 9, 3)],
                         ids=lambda r: f"W{len(r)}")
def test_apply_split_is_the_rank_order_sum_then_the_apply(rows, act, dtype):
    rng = np.random.default_rng(len(rows) * 7 + ACTS.index(act))
    c = 12
    x = torch.from_numpy((rng.standard_normal((sum(rows), c)) * 2 + 5)
                         .astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((sum(rows), c)).astype(
        np.float32)).to(dtype)
    scale, offset = _chan(rng, c)
    mean, _, inv = fn.bn_stats_plain(x)
    parts = list(zip(g.split(list(rows)), x.split(list(rows))))
    w = len(rows)
    sums = sum(fn.bn_bwd_local(gp, xp, mean, inv, scale, offset, i, w, act)
               for i, (gp, xp) in enumerate(parts))
    reds = [fn.bn_bwd_reduce_plain(gp, xp, mean, inv, scale, offset, act)
            for gp, xp in parts]
    # the slot form summed is the sums stacked
    assert torch.equal(sums.view(torch.int32),
                       torch.stack(reds).view(torch.int32))
    # sum_in_rank_order's loop: a clone of row 0, then += of the next rows
    total = sums[0].clone()
    for r in range(1, w):
        total += sums[r]
    n = sum(rows)
    for gp, xp in parts:
        want = fn.bn_bwd_apply_plain(gp, xp, mean, inv, scale, offset, total,
                                     act, n)
        got = fn.bn_bwd_apply_split(gp, xp, mean, inv, scale, offset, sums,
                                    n, act)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(got, fn.bn_bwd_apply_split_plain(
            gp, xp, mean, inv, scale, offset, sums, n, act))


@pytest.fixture(scope="module")
def ranks():
    """Per world size, (payload, each rank's result) of
    ``_torch_dist.bn_split_bwd_worker``: the exchange's bits on 2 and 3
    ranks, the BN cases on 2 and 4."""
    jobs = {}
    for world in (2, 3, 4):
        rng = np.random.default_rng(80 + world)
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
        c = 7
        x = (rng.standard_normal((5 * world, c)) + 4.0).astype(np.float32)
        g = rng.standard_normal((5 * world, c)).astype(np.float32)
        g[:, 3] = -0.0  # sums of -0, +0 after either exchange
        payload = {"x": x, "g": g, "act": "leaky_relu", "cases": cases,
                   "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "offset": (0.1 * rng.standard_normal(c)).astype(
                       np.float32)}
        jobs[world] = (payload, _torch_dist.start("bn_split_bwd_worker",
                                                  world, payload))
    return {w: (p, job.join()) for w, (p, job) in jobs.items()}


@pytest.mark.parametrize("world", [2, 3])
def test_slot_form_through_all_reduce_stack_is_gather_stack(ranks, world):
    _, results = ranks[world]
    for r in results:
        np.testing.assert_array_equal(r["slot"], r["stack"])
        np.testing.assert_array_equal(r["slot"], results[0]["slot"])
        np.testing.assert_array_equal(r["dx"], r["chain"])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_split_backward_makes_one_exchange(ranks, world):
    """No gather_stack and no sum_in_rank_order: the forward's one
    all_reduce of its [W, 3, C] triples, the backward's one of its
    [W, 2, C] sums."""
    _, results = ranks[world]
    for r in results:
        assert r["calls"] == {"forward": [(world, 3, 7)],
                              "backward": [(world, 2, 7)]}


@pytest.mark.parametrize("i", range(len(ACTS)), ids=[str(a) for a in ACTS])
@pytest.mark.parametrize("world", [2, 4])
def test_group_bn_backward_matches_jax_over_the_whole_batch(ranks, world,
                                                            i):
    payload, results = ranks[world]
    want = _jax_reference(payload["cases"][i])
    got = [r["bn"][i] for r in results]
    _within(np.concatenate([g["dx"] for g in got]), want["dx"])
    for key in ("dscale", "doffset"):
        _within(sum(g[key] for g in got), want[key])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", [s[0] for s in sweep_tool.SHAPES])
def test_sweep_candidates_are_valid_plans(name, dtype):
    """``tools/sweep_stats_local.py`` at ``bn_bwd_local``: the chosen plan
    first, every candidate a plan of the same shape that covers its rows,
    none twice."""
    _, per, c = next(s for s in sweep_tool.SHAPES if s[0] == name)
    r = sweep_tool.B * per // 2
    cands = sweep_tool.candidates(fn, r, c, dtype, "bn_bwd_local")
    assert cands[0] == fn.bn_bwd_local_plan(r, c, dtype)
    assert len(set(cands)) == len(cands) > 1
    for p in cands:
        assert 1 <= p.cluster <= 16
        assert p.tx * p.ty == cands[0].tx * cands[0].ty
        assert p.rows * (p.cluster - 1) < r <= p.rows * p.cluster
        groups = p.ty // (32 // p.tx if p.tx < 32 else 1)
        assert p.smem == (groups + 1 + p.cluster) * 2 * p.ct * 4


def test_sweep_bwd_inputs_and_the_card():
    g, scale, offset, act = sweep_tool.bwd_inputs("E.BN2", torch.bfloat16,
                                                  "cpu")
    assert g.shape == (sweep_tool.B * 64, 128) and g.dtype == torch.bfloat16
    assert scale.shape == offset.shape == (128,) and act == "leaky_relu"
    assert sweep_tool.bwd_inputs("G.BN3", torch.float32, "cpu")[3] == "relu"
    with pytest.raises(RuntimeError):
        sweep_tool.sweep()
