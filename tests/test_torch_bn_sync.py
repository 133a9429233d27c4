"""Batch statistics over the rows of several ranks (``graphical_gan_tpu_
torch/ops/kernels/fused_norm.py``: K2a's and K2c+K2d's split modes and
the second-order term with its group sums), on 2 and 3 gloo ranks on the
CPU, against the same BN over the whole batch in one process.

- The split K2a's plain versions: each part's f64 (n, mean, M2) merged in
  rank order (``bn_stats_merge_plain``) equals the one-pass statistics of
  the concatenated rows (``bn_stats_plain``) to f32 rounding, also for
  parts of unequal size and a mean far from 0.
- The split K2c+K2d's plain versions: the parts' sums in their slots of
  the exchange buffer, summed, then dx over the group's rows, equal
  ``bn_bwd_plain`` on the concatenation.
- Through ``fused_batchnorm_act(..., group=)`` on the ranks: y, dx, and the
  scale and offset gradients summed over the ranks, and the second order
  (the gradient of ``sum(dx * v)`` w.r.t. x and scale) equal the
  one-process BN's to 1e-5 of the largest reference value (f32 sums taken
  in other orders).
"""

import numpy as np
import pytest
import torch

import _torch_dist
from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
from _torch_threads import one_thread  # noqa: F401

ACTS = [None, "relu", "leaky_relu"]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


@pytest.mark.parametrize("sizes", [(6, 6), (4, 4, 4), (3, 7), (5, 1, 9)])
def test_stats_merge_equals_whole_batch(sizes):
    rng = np.random.default_rng(sum(sizes))
    x = (300.0 + rng.standard_normal((sum(sizes), 11))).astype(np.float32)
    parts = torch.split(torch.from_numpy(x), list(sizes))
    merged = fn.bn_stats_merge_plain(torch.stack(
        [fn.bn_stats_local_plain(p) for p in parts]))
    mean, var, inv = fn.bn_stats_plain(torch.from_numpy(x))
    _close(merged[0], mean, 1e-6)
    _close(merged[1], var, 1e-5)
    _close(merged[2], inv, 1e-5)
    # one part: the rows' own statistics
    one = fn.bn_stats_merge_plain(fn.bn_stats_local_plain(
        torch.from_numpy(x))[None])
    _close(one[0], mean, 1e-6)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("world", [2, 3])
def test_bwd_split_equals_whole_batch(world, act):
    rng = np.random.default_rng(world)
    x = torch.from_numpy(rng.standard_normal((6 * world, 5))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32))
    offset = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    mean, _, inv = fn.bn_stats_plain(x)
    want_dx, want_red = fn.bn_bwd_plain(g, x, mean, inv, scale, offset, act)
    parts = list(zip(g.chunk(world), x.chunk(world)))
    # each rank's slot of the exchange buffer, summed as the all_reduce
    # sums them
    sums = sum(fn.bn_bwd_local(gp, xp, mean, inv, scale, offset, i, world,
                               act) for i, (gp, xp) in enumerate(parts))
    _close(sums.sum(0), want_red)
    dx = torch.cat([fn.bn_bwd_apply_split(gp, xp, mean, inv, scale, offset,
                                          sums, x.shape[0], act)
                    for gp, xp in parts])
    _close(dx, want_dx)


def _case(rng, rows, c, act, shape4=True):
    shape = (rows, 2, 3, c) if shape4 else (rows, c)
    return dict(
        x=rng.standard_normal(shape).astype(np.float32),
        gy=rng.standard_normal(shape).astype(np.float32),
        v=rng.standard_normal(shape).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
        offset=(0.1 * rng.standard_normal(c)).astype(np.float32), act=act)


def _whole(c):
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    scale = torch.from_numpy(c["scale"]).requires_grad_(True)
    offset = torch.from_numpy(c["offset"]).requires_grad_(True)
    y = fn.fused_batchnorm_act(x, scale, offset, c["act"])
    dx, ds, do = torch.autograd.grad((y * torch.from_numpy(c["gy"])).sum(),
                                     (x, scale, offset), create_graph=True)
    ddx, dds = torch.autograd.grad((dx * torch.from_numpy(c["v"])).sum(),
                                   (x, scale))
    return {k: t.detach().numpy() for k, t in dict(
        y=y, dx=dx, dscale=ds, doffset=do, ddx=ddx, ddscale=dds).items()}


@pytest.fixture(scope="module")
def ranks():
    out = {}
    jobs = {}
    for world in (2, 3):
        rng = np.random.default_rng(40 + world)
        cases = [_case(rng, 2 * world, 6, act, shape4=i != 2)
                 for i, act in enumerate(ACTS)]
        jobs[world] = (cases, _torch_dist.start("bn_sync_worker", world,
                                                cases))
    for world, (cases, job) in jobs.items():
        out[world] = (cases, job.join())
    return out


@pytest.mark.parametrize("i", range(len(ACTS)))
@pytest.mark.parametrize("world", [2, 3])
def test_group_bn_equals_whole_batch(ranks, world, i):
    cases, results = ranks[world]
    want = _whole(cases[i])
    got = [r[i] for r in results]
    for key in ("y", "dx", "ddx"):
        _close(np.concatenate([g[key] for g in got]), want[key])
    for key in ("dscale", "doffset", "ddscale"):
        _close(sum(g[key] for g in got), want[key])
