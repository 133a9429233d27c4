"""Q2's Hopper design and Q1 folded into the BN apply, on the CPU
(``graphical_gan_tpu_torch/ops/kernels/quant.py``, ``ops/quant.py``,
``ops/kernels/fused_norm.py: bn_apply_q8``), against the JAX package's
``graphical_gan_tpu/ops/quant.py``.

- The K-major filter (``pack_filter``): its layout against HWIO, and the
  intercepts that run on it (conv at stride 1 and 2, the phase deconv at
  k 5 and 4, dense) against JAX's intercepts bit for bit, their int32 sums
  against JAX's int8 contractions.
- ``q2_plan``: the route, tile, K depth, ring and splits at the layers of
  the published int8 samplers (cifar10 and mnist family 1, celeba, GMGAN
  mnist, SSGAN moving-MNIST's frame generator and dense layers) at buckets
  8, 64 and 256, their invariants, and the shapes themselves against a
  recorded sampler call.
- Split K: the int32 sums of a plan's K splits add up to the whole.
- The fused epilogue's plain version (``bias_act_plain`` after the
  dequantize) against JAX's ``(f32(acc) * factor).astype(dt) + b`` and
  activation, in f32 and bf16, on random values and on constructed ties.
- The dual-output K2b's plain version against the BN apply then Q1, and,
  on an identity BN over half steps, against JAX's ``_q8``.
- The first-call pairing: cifar10's three BNs feed their deconvs' int8
  copies (one standalone Q1 a later dispatch, the latents'), mnist's crop
  and celeba's BN-free generator keep the standalone Q1; every output bit
  stays as the first call's.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from graphical_gan_tpu.ops import activations as jax_act
from graphical_gan_tpu.ops import quant as jq
from graphical_gan_tpu_torch.ops import quant as tq
from graphical_gan_tpu_torch.ops.kernels import fused_norm as kn
from graphical_gan_tpu_torch.ops.kernels import quant as kq
from graphical_gan_tpu_torch.ops.phase_deconv import _phase_plan
from graphical_gan_tpu_torch.serve.export import make_sampler
from graphical_gan_tpu_torch.serve.quantize import quantized_entry
from graphical_gan_tpu_torch.tools import sweep_q2_plan

import _torch_family1 as fam1
from _torch_threads import one_thread  # noqa: F401

DTYPES = ["float32", "bfloat16"]
STEP = 2.0 ** -5    # a power-of-two activation scale: half steps are ties


def _bits(t):
    """An integer view of a tensor's bits (f32, bf16) or the tensor."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return (t.view(torch.int32) if t.dtype == torch.float32 else t
                ).numpy()
    a = np.asarray(t)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def _half_steps(rng, shape):
    """Integers and half-integers times STEP, some past ±127.5 steps."""
    j = rng.integers(-130, 130, shape).astype(np.float32)
    return ((j + 0.5 * (rng.random(shape) < 0.5)) * STEP).astype(np.float32)


def _pair(x, dtype):
    return (jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# the K-major filter

@pytest.mark.parametrize("shape", [(5, 5, 6, 7), (3, 3, 64, 12),
                                   (1, 1, 13, 130), (3, 3, 32, 512)])
def test_pack_filter_layout_against_hwio(shape):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    pf = kq.pack_filter(w)
    kh, kw, cin, cout = shape
    rows = kq.filter_rows(cout)
    assert pf.hwio_shape == shape and pf.wk.dtype == torch.int8
    assert pf.wk.shape == (rows, kh * kw * cin) and pf.wk.is_contiguous()
    assert rows % kq.n_tile(cout) == 0 and rows - cout < kq.n_tile(cout)
    for n, i, j, c in [(0, 0, 0, 0), (cout - 1, kh - 1, kw - 1, cin - 1),
                       (cout // 2, kh // 2, 0, cin // 3)]:
        assert pf.wk[n, (i * kw + j) * cin + c] == w[i, j, c, n]
    assert not pf.wk[cout:].any()
    assert torch.equal(kq.unpack_filter(pf), w)


LAYERS = ["conv_s1", "conv_s2", "deconv_k5", "deconv_k4", "dense"]


def _layer_case(layer, rng, dtype):
    """(JAX's intercept output, the port's, JAX's int32 sums, the sums of
    the filter the port's weight cache holds) of one layer on random
    weights, x on half steps of STEP."""
    if layer == "dense":
        x = _half_steps(rng, (9, 40))
        w = (0.1 * rng.standard_normal((40, 6))).astype(np.float32)
    elif layer.startswith("conv"):
        x = _half_steps(rng, (2, 9, 8, 6))
        w = (0.1 * rng.standard_normal((5, 5, 6, 7))).astype(np.float32)
    else:
        k = int(layer[-1])
        x = _half_steps(rng, (2, 4, 5, 6))
        w = (0.1 * rng.standard_normal((k, k, 7, 6))).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    cache = {}
    if layer == "dense":
        s_w = jq._w_scales(jw, 1)
        sums = lax.dot_general(jq._q8(jx, STEP), jq._q8(jw, s_w),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
        with jq.quantized({"l": STEP}):
            want = jq.intercept_linear("l", jx, jw)
        with tq.quantized({"l": STEP}, cache):
            got = tq.intercept_linear("l", tx, tw)
        xq = kq.quantize_int8(tx, STEP).reshape(9, 1, 1, 40)
        port = kq.int8_conv_packed(xq, cache["l"][2], None, 1, "VALID",
                                   torch.int32).reshape(9, 6)
    elif layer.startswith("conv"):
        stride = int(layer[-1])
        s_w = jq._w_scales(jw, 3)
        sums = lax.conv_general_dilated(
            jq._q8(jx, STEP), jq._q8(jw, s_w), (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        with jq.quantized({"c": STEP}):
            want = jq.intercept_conv2d("c", jx, jw, stride, "SAME")
        with tq.quantized({"c": STEP}, cache):
            got = tq.intercept_conv2d("c", tx, tw, stride, "SAME")
        port = kq.int8_conv_packed(kq.quantize_int8(tx, STEP), cache["c"][2],
                                   None, stride, "SAME", torch.int32)
    else:
        k = int(layer[-1])
        s_w = jq._w_scales(jw, 2)
        sums = lax.conv_transpose(
            jq._q8(jx, STEP), jq._q8(jw, s_w[None, None, :, None]), (2, 2),
            "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            transpose_kernel=True, preferred_element_type=jnp.int32)
        with jq.quantized({"d": STEP}):
            want = jq.intercept_deconv2d("d", jx, jw, 2, "SAME")
        with tq.quantized({"d": STEP}, cache):
            got = tq.intercept_deconv2d("d", tx, tw, 2, "SAME")
        pl, pr = _phase_plan(k)[:2]
        out4 = kq.int8_conv_packed(kq.quantize_int8(tx, STEP), cache["d"][2],
                                   None, 1, ((pl, pr), (pl, pr)),
                                   torch.int32)
        b, h, wd = out4.shape[:3]
        port = out4.reshape(b, h, wd, 2, 2, 7).permute(0, 1, 3, 2, 4, 5
                                                       ).reshape(b, 2 * h,
                                                                 2 * wd, 7)
    return want, got, sums, port


@pytest.mark.parametrize("layer", LAYERS)
def test_intercepts_on_the_packed_filter_equal_jax(layer):
    """Every layer in f32 and bf16: the dequantized intercept bit for bit,
    and the int32 sums of the filter the weight cache holds K-major."""
    for i, dtype in enumerate(DTYPES):
        want, got, sums, port = _layer_case(
            layer, np.random.default_rng(10 + i), dtype)
        assert isinstance(port, torch.Tensor) and port.dtype == torch.int32
        _assert_bits(port.contiguous(), sums)
        assert got.dtype == getattr(torch, dtype)
        _assert_bits(got, want)


# ---------------------------------------------------------------------------
# the plan

# the Q2 calls of the published int8 samplers at batch b: (layer, x shape,
# KH = KW, Cout, pads); a deconv as its phase conv
_PHASE = ((1, 1), (1, 1))
_DENSE = ((0, 0), (0, 0))


def sampler_q2_shapes(family, b):
    if family == "cifar10":
        return [("Generator.Input", (b, 1, 1, 128), 1, 4096, _DENSE),
                ("Generator.2", (b, 4, 4, 256), 3, 512, _PHASE),
                ("Generator.3", (b, 8, 8, 128), 3, 256, _PHASE),
                ("Generator.5", (b, 16, 16, 64), 3, 12, _PHASE)]
    if family in ("mnist", "gmgan-mnist"):
        return [("Generator.Input", (b, 1, 1, 128), 1, 4096, _DENSE),
                ("Generator.2", (b, 4, 4, 256), 3, 512, _PHASE),
                ("Generator.3", (b, 7, 7, 128), 3, 256, _PHASE),
                ("Generator.5", (b, 14, 14, 64), 3, 4, _PHASE)]
    if family == "celeba":
        return [("Generator.Input", (b, 1, 1, 128), 1, 4096, _DENSE),
                ("Generator.2", (b, 4, 4, 256), 3, 512, _PHASE),
                ("Generator.3", (b, 8, 8, 128), 3, 256, _PHASE),
                ("Generator.4", (b, 16, 16, 64), 3, 128, _PHASE),
                ("Generator.5", (b, 32, 32, 32), 3, 12, _PHASE)]
    f = 16 * b  # SSGAN moving-MNIST: LEN 16 frames a row
    return [("Dynamic.in", (b, 1, 1, 16), 1, 256, _DENSE),
            ("Dynamic.hidden", (b, 1, 1, 256), 1, 256, _DENSE),
            ("Dynamic.out", (b, 1, 1, 256), 1, 8, _DENSE),
            ("Generator.Input", (f, 1, 1, 146), 1, 4096, _DENSE),
            ("Generator.2", (f, 4, 4, 256), 3, 512, _PHASE),
            ("Generator.3", (f, 8, 8, 128), 3, 256, _PHASE),
            ("Generator.4", (f, 16, 16, 64), 3, 128, _PHASE),
            ("Generator.5", (f, 32, 32, 32), 3, 4, _PHASE)]


FAMILIES = ["cifar10", "mnist", "celeba", "ssgan"]


@pytest.mark.parametrize("b", [8, 64, 256])
@pytest.mark.parametrize("family", FAMILIES)
def test_q2_plan_at_the_sampler_shapes(family, b):
    for name, shape, k, cout, pads in sampler_q2_shapes(family, b):
        p = kq.q2_plan(shape, k, k, cout, 1, pads)
        cin = shape[3]
        assert p == kq.q2_plan(shape, k, k, cout, 1, pads)  # pure
        assert p.m == shape[0] * shape[1] * shape[2] and p.n == cout
        assert p.dense == (k == 1)
        if cin % 32:  # SSGAN's K 16 and 146 dense layers
            assert p.route == "mma", name
            assert (p.bm, p.bn, p.bk, p.splits) == (64, 64, 32, 1)
            assert p.steps == -(-k * k * cin // 32)
            continue
        assert p.route == "tma", name
        assert p.bk in kq.TMA_BK and cin % p.bk == 0
        assert p.bk == max(bk for bk in kq.TMA_BK if cin % bk == 0)
        assert p.steps == k * k * cin // p.bk
        assert p.bn in kq.Q2_BN and kq.filter_rows(cout) % p.bn == 0
        assert p.bm in (64, 128)
        # every step in one split, none empty
        assert p.splits * p.per >= p.steps > (p.splits - 1) * p.per
        assert 1 <= p.stages <= min(kq.MAX_STAGES, p.per)
        assert p.stages * (p.bm + p.bn) * p.bk <= kq.RING_BYTES
        if p.splits > 1:
            assert not kq.fills_wave(p.tiles)
            assert 4 * p.m * cout < kq.SPLIT_WS_BYTES
            assert p.blocks <= kq.SMS
        if kq.fills_wave(kq.n_tiles(p.m, cout, 128, 128), 2) and cout > 64:
            assert (p.bm, p.bn) == (128, 128)


def test_q2_plan_cifar10_choices():
    """The choices tools/sweep_q2_plan.py measured best, or within 2%, at
    cifar10's layers on the H100."""
    want = {8: [(64, 64, 1), (64, 64, 6), (64, 64, 1), (64, 16, 3)],
            64: [(64, 64, 1), (64, 64, 1), (64, 64, 1), (64, 16, 1)],
            256: [(64, 64, 1), (128, 64, 1), (128, 128, 1), (128, 16, 1)]}
    for b, rows in want.items():
        got = [(p.bm, p.bn, p.splits) for p in (
            kq.q2_plan(shape, k, k, cout, 1, pads)
            for _, shape, k, cout, pads in sampler_q2_shapes("cifar10", b))]
        assert got == rows, b
    assert kq.q2_plan((8, 4, 4, 256), 3, 3, 512, 1, _PHASE,
                      route="mma").route == "mma"
    assert kq.q2_plan((8, 4, 4, 256), 3, 3, 512, 1, _PHASE,
                      aligned=False).route == "mma"


@pytest.mark.parametrize("b", sweep_q2_plan.BATCHES)
@pytest.mark.parametrize("layer", [s[0] for s in sweep_q2_plan.SHAPES])
def test_sweep_candidates_hold_the_plan_and_its_rules(layer, b):
    """tools/sweep_q2_plan.py times the chosen plan among tma plans that
    differ in tile, stages and splits, at the shape table's cifar10
    layers; each covers every K step once, within the ring's and a
    block's shared memory."""
    name, hwc, k, cout, pads = next(s for s in sweep_q2_plan.SHAPES
                                    if s[0] == layer)
    assert (name, (b,) + hwc, k, cout, pads) in sampler_q2_shapes(
        "cifar10", b)
    p = kq.q2_plan((b,) + hwc, k, k, cout, 1, pads)
    for dt in (torch.float32, torch.bfloat16):
        cands = sweep_q2_plan.candidates(p, dt)
        assert cands.count(p) == 1 and len(set(cands)) == len(cands) > 1
        for c in cands:
            assert (c.route, c.bk, c.steps, c.m, c.n, c.dense) == (
                p.route, p.bk, p.steps, p.m, p.n, p.dense)
            assert c.splits * c.per >= c.steps > (c.splits - 1) * c.per
            assert 1 <= c.stages <= min(kq.MAX_STAGES, c.per)
            assert c.bn in kq.Q2_BN and c.bm in (64, 128)
            assert sweep_q2_plan.smem_bytes(c, dt) <= sweep_q2_plan.SMEM_MAX


def test_recorded_sampler_calls_match_the_shape_table():
    """The table above is what the cifar10 and celeba samplers' intercepts
    call at the published widths (here at batch 2)."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    for family in ("cifar10", "celeba"):
        model = GanInferenceModel(gan_inference_defaults(family, "ali"))
        params = model.init(0, "cpu")
        names = [n for n, *_ in sampler_q2_shapes(family, 2)]
        scales = {n: 0.05 for n in names}
        calls = []
        real = tq.int8_conv_packed

        def rec(xq, pf, factor, stride, pads, *a, **k):
            calls.append((tuple(xq.shape), pf.kh, pf.cout, kq._pads(
                xq.shape[1], xq.shape[2], pf.kh, pf.kw, stride,
                kq.explicit_pads(pads))))
            return real(xq, pf, factor, stride, pads, *a, **k)
        tq.int8_conv_packed = rec
        try:
            with torch.inference_mode():
                quantized_entry(make_sampler("gan_inference", model)[0],
                                scales)(params, 0, torch.zeros(2, 128))
        finally:
            tq.int8_conv_packed = real
        assert calls == [(s, k, c, p) for _, s, k, c, p in
                         sampler_q2_shapes(family, 2)]


# ---------------------------------------------------------------------------
# split K

@pytest.mark.parametrize("x_shape,k,cout,bk,splits", [
    ((2, 4, 4, 256), 3, 40, 128, 6),     # G.2's 18 steps at B 8
    ((2, 6, 5, 64), 3, 12, 64, 3),       # G.5's 9 steps
    ((2, 5, 5, 32), 3, 8, 32, 4),        # SSGAN's Cin 32
    ((3, 1, 1, 256), 1, 10, 128, 2),     # a dense layer
])
def test_split_partials_add_up_to_the_whole(x_shape, k, cout, bk, splits):
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, x_shape, dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, x_shape[3], cout),
                                       dtype=np.int8))
    pads = _PHASE if k == 3 else _DENSE
    p = kq.q2_plan(tuple(x_shape), k, k, cout, 1, pads)
    assert p.route == "tma" and p.bk == bk
    per = -(-p.steps // splits)
    p = dataclasses.replace(p, splits=-(-p.steps // per), per=per)
    parts = kq.split_sums_plain(xq, kq.pack_filter(wq), 1, pads, p)
    assert len(parts) == p.splits > 1
    whole = kq.int8_conv_sums_plain(xq, wq, 1, pads)
    assert torch.equal(torch.stack(parts).sum(0, dtype=torch.int32), whole)
    # each part is its steps' own taps and channel blocks: no two overlap
    assert all(bool(part.any()) for part in parts)


# ---------------------------------------------------------------------------
# the fused epilogue

def _acc_factor_bias(kind, rng, n=64, c=8):
    """int32 sums, an f32 factor per column and an f32 bias: random, or
    built so that the bf16 rounding of the product, the bias's sum (in
    f32 and bf16) and the leaky slope's product land on ties."""
    if kind == "random":
        acc = rng.integers(-2 ** 20, 2 ** 20, (n, c)).astype(np.int32)
        factor = (rng.random(c) * 1e-4).astype(np.float32)
        bias = rng.standard_normal(c).astype(np.float32)
        return acc, factor, bias
    # odd 9-bit significands times 2^j: halfway between two bf16 values
    sig = 2 * rng.integers(128, 256, (n, c)) + 1
    sign = np.where(rng.random((n, c)) < 0.5, -1, 1)
    acc = (sign * sig * 2 ** rng.integers(0, 10, (n, c))).astype(np.int32)
    factor = np.full(c, 2.0 ** -8, np.float32)
    # bias at half an f32 ulp of 2^7 (the product's scale) or a bf16 tie
    bias = np.where(np.arange(c) % 2 == 0, 2.0 ** -17,
                    2.0 ** -1 + 2.0 ** -9).astype(np.float32)
    return acc, factor, bias


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_fused_epilogue_plain_equals_jax(kind, dtype, act):
    acc, factor, bias = _acc_factor_bias(kind, np.random.default_rng(7))
    jdt = jnp.dtype(dtype)
    y = (jnp.asarray(acc).astype(jnp.float32) * jnp.asarray(factor)
         ).astype(jdt)
    want = jax_act.activation(act)(y + jnp.asarray(bias).astype(jdt))
    got = kq.bias_act_plain(
        kq.dequantize_plain(torch.from_numpy(acc), torch.from_numpy(factor),
                            getattr(torch, dtype)),
        torch.from_numpy(bias), act)
    _assert_bits(got, want)
    # and through the Q2 wrapper: the fused call equals its parts
    xq = torch.from_numpy(np.random.default_rng(8).integers(
        -127, 128, (2, 3, 3, 16), dtype=np.int8))
    pf = kq.pack_filter(torch.from_numpy(np.random.default_rng(9).integers(
        -127, 128, (3, 3, 16, 8), dtype=np.int8)))
    f, b = torch.from_numpy(factor), torch.from_numpy(bias)
    fused = kq.int8_conv_packed(xq, pf, f, 1, "SAME", getattr(torch, dtype),
                                b, act)
    parts = kq.bias_act_plain(kq.int8_conv_packed(
        xq, pf, f, 1, "SAME", getattr(torch, dtype)), b, act)
    _assert_bits(fused, parts)


def test_q2_wrappers_refuse_what_no_route_takes():
    xq = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    pf = kq.pack_filter(torch.zeros((3, 3, 32, 8), dtype=torch.int8))
    one = torch.ones(8)
    with pytest.raises(ValueError, match="no bias or activation"):
        kq.int8_conv_packed(xq, pf, None, 1, "SAME", torch.int32, one)
    with pytest.raises(ValueError, match="unknown activation"):
        kq.int8_conv_packed(xq, pf, one, 1, "SAME", torch.float32, None,
                            "tanh")
    with pytest.raises(ValueError, match="bias of shape"):
        kq.int8_conv_packed(xq, pf, one, 1, "SAME", torch.float32,
                            torch.ones(3))
    bad = kq.PackedFilter(pf.wk[:, :-16], 3, 3, 32, 8)
    with pytest.raises(ValueError, match="packed filter"):
        kq.int8_conv_packed(xq, bad, one, 1, "SAME", torch.float32)
    with pytest.raises(ValueError, match="do not form"):
        kq.int8_conv_packed(torch.zeros((1, 4, 4, 16), dtype=torch.int8),
                            pf, one, 1, "SAME", torch.float32)
    with pytest.raises(ValueError, match="only the 'mma' route"):
        kq.q2_plan((1, 4, 4, 32), 3, 3, 8, 1, _PHASE, route="tma")


# ---------------------------------------------------------------------------
# K2b with its int8 copy

@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dual_output_k2b_plain_equals_bn_then_q1(dtype, act):
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((96, 24)) * 2 + 1).astype(
        np.float32)).to(getattr(torch, dtype))
    scale = torch.from_numpy((rng.random(24) + 0.5).astype(np.float32))
    offset = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    s_x = 0.0213
    mean, _, inv = kn.bn_stats(x)
    y, q = kn.bn_apply_q8(x, mean, inv, scale, offset, act, s_x)
    y0 = kn.bn_apply(x, mean, inv, scale, offset, act)
    _assert_bits(y, y0)
    assert torch.equal(q, kq.quantize_int8(y0, s_x))
    # the whole BN: the layer function's output and its copy
    y4, q4 = kn.batchnorm_act_q8(x.reshape(2, 4, 12, 24), scale, offset, act,
                                 s_x)
    _assert_bits(y4.reshape(96, 24),
                 kn.fused_batchnorm_act(x, scale, offset, act))
    assert torch.equal(q4.reshape(96, 24), q)
    # an identity BN over half steps of a power-of-two scale: the copy is
    # JAX's _q8 of x, ties to even
    xh = _half_steps(rng, (40, 8))
    jx, tx = _pair(xh, dtype)
    zeros, ones = torch.zeros(8), torch.ones(8)
    yh, qh = kn.bn_apply_q8(tx, zeros, ones, ones, zeros, None, STEP)
    _assert_bits(yh, tx)
    _assert_bits(qh, jq._q8(jx, STEP))


# ---------------------------------------------------------------------------
# the first-call pairing

def _dispatches(dataset, n=3):
    """Standalone Q1 launches (per-tensor: the activations) of each of
    ``n`` calls of one quantized sampler at small widths, its outputs and
    its weight cache."""
    _, tm, _, tp = fam1.models(dataset, "ali")
    names = [n_ for n_ in ("Generator.Input", "Generator.2", "Generator.3",
                           "Generator.4", "Generator.5")]
    fn = make_sampler("gan_inference", tm)[0]
    weights = {}
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, tm.cfg.dim_latent), np.float32))
    counts, outs = [], []
    real = tq.quantize_int8

    def rec(x, s, axis=None):
        if axis is None:
            counts[-1] += 1
        return real(x, s, axis)
    tq.quantize_int8 = rec
    try:
        with torch.inference_mode():
            for _ in range(n):
                counts.append(0)
                with tq.quantized({k: 0.03 for k in names}, weights):
                    outs.append(fn(tp, 0, z))
    finally:
        tq.quantize_int8 = real
    return counts, outs, weights


@pytest.mark.parametrize("dataset,pairs,later", [
    ("cifar10", {"Generator.BN1": "Generator.2",
                 "Generator.BN2": "Generator.3",
                 "Generator.BN3": "Generator.5"}, 1),
    # the 8x8 -> 7x7 crop between BN2 and Generator.3 is no view of all of
    # BN2's output
    ("mnist", {"Generator.BN1": "Generator.2",
               "Generator.BN3": "Generator.5"}, 2),
    ("celeba", {}, 5),  # no BN in celeba's generator
])
def test_first_call_pairs_each_bn_with_the_layer_it_feeds(dataset, pairs,
                                                           later):
    counts, outs, weights = _dispatches(dataset)
    n_layers = 5 if dataset == "celeba" else 4
    assert counts == [n_layers, later, later]
    assert weights[tq.PAIRS] == pairs
    for o in outs[1:]:
        _assert_bits(o, outs[0])


def test_pairing_is_inert_outside_int8_contexts():
    assert tq.bn_consumer_scale("Generator.BN1") is None
    tq.bn_produced("Generator.BN1", torch.ones(2))  # no context: no state
    with tq.calibrating({}):
        assert tq.bn_consumer_scale("Generator.BN1") is None
