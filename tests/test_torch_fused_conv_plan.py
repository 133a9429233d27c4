"""K1's plan (graphical_gan_tpu_torch/ops/kernels/fused_conv.py: plan), a
pure function of the shapes, at every shape the main paths run, and the
split-K summation order it sets, emulated in plain PyTorch and held against
the JAX ``fused_conv2d_bias_act`` Pallas kernel in interpret mode.

The plan's kernels run only on the card (chip_smoke.py holds each of them
against the plain version there); here the plan's arithmetic is checked:
every reduction column lies in exactly one split, the tile or, in bf16, the
splits fill a wave of the H100's 132 SMs where the shape allows, f32 never
takes the tensor cores and is never split (its one FMA chain per output in
HWIO order is the CPU convolution's order, which is checked too), and
Cin < 8 takes the element-gather path.

Tolerances of the emulation against JAX: test_torch_fused_conv.py's, f32
atol/rtol 1e-4; bf16 max |Δ| within 2e-2 of max(1, max |ref|).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas.fused_conv import (
    fused_conv2d_bias_act as jax_fused)
from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.kernels import fused_conv
from graphical_gan_tpu_torch.ops.kernels.fused_conv import (
    F32_TILES, MIN_SPLIT_STEPS, SMS, SPLIT_WAVES, WGMMA_TILES, fills_wave,
    plan, same_pads)
from graphical_gan_tpu_torch.tools import sweep_k1_plan

# (name, x shape NHWC, Cout, K, stride, padding)
SHAPES = (
    # cifar10 / svhn E.1-3 (D.1-3 run the same shapes) at B 8 / 64 / 256
    [(f"cifar E.{i + 1} B={b}", (b, h, h, cin), cout, 5, 2, "SAME")
     for b in (8, 64, 256)
     for i, (h, cin, cout) in enumerate(((32, 3, 64), (16, 64, 128),
                                         (8, 128, 256)))]
    # mnist E/D at B=50, celeba E/D at B=128 (the published batches)
    + [(f"mnist E.{i + 1}", (50, h, h, cin), cout, 5, 2, "SAME")
       for i, (h, cin, cout) in enumerate(((28, 1, 64), (14, 64, 128),
                                           (7, 128, 256)))]
    + [(f"celeba E.{i + 1}", (128, h, h, cin), cout, 5, 2, "SAME")
       for i, (h, cin, cout) in enumerate(((64, 3, 32), (32, 32, 64),
                                           (16, 64, 128), (8, 128, 256)))]
    # tests/test_torch_fused_conv.py's cases (test_pallas_conv.py's)
    + [(f"jax case {i}", (b, h, w, cin), cout, k, s, pad)
       for i, (b, h, w, cin, cout, k, s, pad) in enumerate([
           (4, 32, 32, 3, 16, 5, 2, "SAME"),
           (4, 16, 16, 16, 32, 5, 2, "SAME"),
           (2, 7, 7, 8, 16, 5, 2, "SAME"),
           (2, 9, 9, 8, 8, 3, 1, "SAME"),
           (2, 12, 12, 8, 8, 5, 2, "VALID"),
           (2, 8, 8, 8, 24, 1, 1, "SAME")])]
    # Cin 1 with a Cout past one 64-wide tile (chip_smoke.py's edge case)
    + [("edge cin1", (3, 5, 5, 1), 70, 3, 1, "SAME")])
DTYPES = [torch.float32, torch.bfloat16]


def _plan(shape, cout, k, stride, padding, dtype):
    return plan(shape, (k, k, shape[3], cout), stride, padding, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_plan_splits_cover_every_column_once(case, dtype):
    _, shape, cout, k, stride, padding = case
    p = _plan(shape, cout, k, stride, padding, dtype)
    assert p.r == k * k * shape[3] and p.n == cout
    assert p.splits >= 1 and p.steps_per_split >= 1
    ranges = p.k_ranges()
    assert len(ranges) == p.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == p.r
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(p.r, None)]):
        assert lo < hi == nxt, "ranges must be contiguous and non-empty"
        assert lo % p.bk == 0, "split boundaries fall on multiples of BK"
    covered = np.zeros(p.r, int)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_plan_fills_a_wave_where_the_k_loop_allows(case, dtype):
    _, shape, cout, k, stride, padding = case
    p = _plan(shape, cout, k, stride, padding, dtype)
    steps = -(-p.r // p.bk)
    # the tile: the largest whose count fills a wave, else the smallest
    tiles = {"fma": F32_TILES, "wgmma": WGMMA_TILES,
             "mma": ((64, 64),)}[p.path]
    tiles = [t for t in tiles if cout > 64 or t[1] == 64]
    full = [t for t in tiles
            if fills_wave(-(-p.m // t[0]) * -(-cout // t[1]))]
    assert (p.bm, p.bn) == (full or tiles[-1:])[0]
    assert fills_wave(SMS) and not fills_wave(SMS * 8 // 10)
    if dtype == torch.float32:  # never split
        assert p.splits == 1
        return
    if fills_wave(p.tiles):
        assert p.splits == 1
    elif fills_wave(-(-steps // MIN_SPLIT_STEPS) * p.tiles, SPLIT_WAVES):
        # the fewest splits that fill SPLIT_WAVES waves
        assert fills_wave(p.blocks, SPLIT_WAVES)
        assert not fills_wave((p.splits - 1) * p.tiles, SPLIT_WAVES)
    else:  # as many splits as MIN_SPLIT_STEPS allows
        assert p.splits == (-(-steps // MIN_SPLIT_STEPS)
                            if steps >= 2 * MIN_SPLIT_STEPS else 1)
    # no split shorter than the floor, except the last one
    assert p.splits == 1 or p.steps_per_split >= MIN_SPLIT_STEPS


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_plan_path_follows_dtype_and_channels(case, dtype):
    _, shape, cout, k, stride, padding = case
    cin = shape[3]
    p = _plan(shape, cout, k, stride, padding, dtype)
    assert p.bm in (32, 64, 128) and p.bn in (64, 128)
    assert p.blocks == p.tiles * p.splits
    if dtype == torch.float32:  # FMAs only: no TF32
        assert (p.path, p.bk, p.splits) == ("fma", 32, 1)
        assert p.vec == (cin % 4 == 0 and cout % 4 == 0)
    elif cin % 8 == 0 and cout % 8 == 0:
        assert (p.path, p.vec, p.bk, p.stages) == ("wgmma", True, 64, 4)
    else:  # Cin < 8: element gathers into a zero-padded K tile
        assert (p.path, p.vec, p.bm, p.bn) == ("mma", False, 64, 64)
    if cin < 8:
        assert not p.vec


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name,b,bf16_split,f32_tile", [
    ("E.2", 8, True, (32, 64)), ("E.3", 8, True, (32, 64)),
    ("E.2", 64, False, (64, 64)), ("E.3", 64, True, (32, 64)),
    ("E.1", 256, False, (64, 64)), ("E.2", 256, False, (128, 128))])
def test_plan_of_the_cifar10_shapes(name, b, bf16_split, f32_tile, dtype):
    """bf16 splits K where even 64 x 64 tiles fill less than a wave (E.3 /
    D.3 at B <= 64, E.2 / D.2 at B = 8; E.2 at B=64 has 128 such tiles);
    f32 takes smaller tiles there instead."""
    case = next(c for c in SHAPES if c[0] == f"cifar {name} B={b}")
    p = _plan(*case[1:], dtype)
    if dtype == torch.bfloat16:
        assert (p.splits > 1) == bf16_split
    else:
        assert p.splits == 1 and (p.bm, p.bn) == f32_tile


def _split_order_plain(x, w, bias, stride, padding, act, p):
    """K1's arithmetic in the plan's order: one f32 partial per split over
    its reduction columns [lo, hi) (rows of the [R, Cout] weight), the
    partials summed in split order, then bias and act in f32 and one
    rounding to x's dtype."""
    kh, kw, cin, cout = w.shape
    wf = w.to(x.dtype).float().reshape(-1, cout)
    zero = torch.zeros(cout)
    total = None
    for lo, hi in p.k_ranges():
        wz = torch.zeros_like(wf)
        wz[lo:hi] = wf[lo:hi]
        part = fused_conv.fused_conv2d_bias_act_plain(
            x.float(), wz.reshape(kh, kw, cin, cout), zero, stride, padding,
            None)
        total = part if total is None else total + part
    y = total + bias.to(x.dtype).float()
    return activation(act)(y).to(x.dtype)


# the cifar10 training shapes at B=2: E.2 and E.3 split K 7 and 13 ways in
# bf16 (f32 is not split)
TRAIN_SHAPES = [("E.1", (2, 32, 32, 3), 64, "leaky_relu"),
                ("E.2", (2, 16, 16, 64), 128, None),
                ("E.3", (2, 8, 8, 128), 256, "leaky_relu")]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TRAIN_SHAPES, ids=[c[0] for c in
                                                    TRAIN_SHAPES])
def test_split_order_matches_pallas(case, dtype):
    _, shape, cout, act = case
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype("float32")
    w = (rng.randn(5, 5, shape[3], cout) * 0.05).astype("float32")
    bias = rng.randn(cout).astype("float32")
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_fused(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(bias), 2, "SAME", act),
                      np.float32)
    xt = torch.from_numpy(x).to(dtype)
    p = plan(tuple(xt.shape), w.shape, 2, "SAME", dtype)
    if case[0] != "E.1" and dtype == torch.bfloat16:
        assert p.splits > 1
    got = _split_order_plain(xt, torch.from_numpy(w), torch.from_numpy(bias),
                             2, "SAME", act, p)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.float().numpy() - want).max()) / scale < 2e-2


def _fma_chain(a, w):
    """out[m, n] = one f32 FMA chain over r = 0..R-1 in order, as the f32
    kernel computes it (the product and sum are exact in f64 before the
    one rounding to f32 that fmaf makes)."""
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    a, w = a.astype(np.float64), w.astype(np.float64)
    for r in range(a.shape[1]):
        acc = (acc + np.outer(a[:, r], w[r])).astype(np.float32)
    return acc


@pytest.mark.parametrize("case", TRAIN_SHAPES, ids=[c[0] for c in
                                                    TRAIN_SHAPES])
def test_f32_chain_order_is_the_cpu_convolutions(case):
    """The premise of never splitting f32: PyTorch's f32 CPU convolution
    (the plain version on a CPU tensor) gives exactly the bits of one FMA
    chain per output over the reduction in HWIO order, the f32 kernel's
    order, at these shapes (Cin 3, 64, 128; at Cin = 1 the CPU takes
    another algorithm)."""
    _, shape, cout, _ = case
    shape = (1,) + shape[1:]
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype("float32")
    w = (rng.randn(5, 5, shape[3], cout) * 0.05).astype("float32")
    cpu = fused_conv.fused_conv2d_bias_act_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.zeros(cout), 2,
        "SAME", None).reshape(-1, cout).numpy()
    lo, hi = same_pads(shape[1], 5, 2)
    xp = np.pad(x, ((0, 0), (lo, hi), (lo, hi), (0, 0)))
    oh = -(-shape[1] // 2)
    cols = np.stack([xp[:, kh:kh + 2 * oh:2, kw:kw + 2 * oh:2, :]
                     for kh in range(5) for kw in range(5)], axis=3)
    got = _fma_chain(cols.reshape(oh * oh, -1), w.reshape(-1, cout))
    assert np.array_equal(got, cpu)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b", sweep_k1_plan.BATCHES)
@pytest.mark.parametrize("shape", sweep_k1_plan.SHAPES,
                         ids=[s[0] for s in sweep_k1_plan.SHAPES])
def test_sweep_candidates_hold_the_plan_and_its_rules(shape, b, dtype):
    """tools/sweep_k1_plan.py times the chosen plan among others of its
    path that differ only in tile and splits; each covers every reduction
    column once, f32 is never split, and no split is shorter than the
    plan's floor (MIN_SPLIT_STEPS steps) but the last."""
    _, h, cin, cout, _ = shape
    p = plan((b, h, h, cin), (5, 5, cin, cout), 2, "SAME", dtype)
    cands = sweep_k1_plan.candidates(p)
    assert cands.count(p) == 1 and len(set(cands)) == len(cands)
    steps = -(-p.r // p.bk)
    for c in cands:
        assert (c.path, c.vec, c.bk, c.stages, c.m, c.n, c.r) == \
            (p.path, p.vec, p.bk, p.stages, p.m, p.n, p.r)
        ranges = c.k_ranges()
        assert ranges[-1][1] == p.r and all(
            lo < hi == nxt for (lo, hi), (nxt, _) in
            zip(ranges, ranges[1:] + [(p.r, None)]))
        assert (c.splits - 1) * c.steps_per_split < steps
        assert c.splits == 1 or c.steps_per_split >= MIN_SPLIT_STEPS
        if dtype == torch.float32:
            assert c.splits == 1


def test_plan_is_cached_and_rejects_other_dtypes():
    args = ((64, 8, 8, 128), (5, 5, 128, 256), 2, "SAME", torch.bfloat16)
    assert plan(*args) is plan(*args)
    with pytest.raises(TypeError):
        plan((1, 8, 8, 8), (3, 3, 8, 8), 1, "SAME", torch.float16)
