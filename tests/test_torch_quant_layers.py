"""The port's int8 layers (``graphical_gan_tpu_torch/ops/quant.py``, Q1 and
Q2 of ``ops/kernels/quant.py``) against the JAX package's
``graphical_gan_tpu/ops/quant.py`` on the CPU.

Given the same numpy x, w and s_x:

- Q1's int8 values equal JAX's ``_q8`` (activations per tensor, weights per
  output channel on the axis each layer names);
- Q2's int32 sums equal JAX's int8 contractions with
  ``preferred_element_type=int32`` (``conv_general_dilated`` at stride 1
  and 2, ``conv_transpose`` through the port's phase route,
  ``dot_general``);
- the dequantized outputs of the intercepts, and of the layers with bias
  and activation, are bit-equal, in f32 and in bf16.

Each case runs twice: on random values at a random scale, and on values
that sit exactly on .5 steps of a power-of-two scale (the weights' absmax
planted so that ``s_w`` is one too), where rounding half to even decides.
The plain Q2 is also held to a numpy int64 reference, and its overflow
check raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.ops import conv2d as jax_conv2d
from graphical_gan_tpu.ops import deconv2d as jax_deconv2d
from graphical_gan_tpu.ops import linear as jax_linear
from graphical_gan_tpu.ops import quant as jq
from graphical_gan_tpu_torch.ops import quant as tq
from graphical_gan_tpu_torch.ops.conv import conv2d, deconv2d
from graphical_gan_tpu_torch.ops.kernels import quant as kq
from graphical_gan_tpu_torch.ops.linear import linear

from _torch_threads import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
DTYPES = ["float32", "bfloat16"]
KINDS = ["random", "half_steps"]
STEP = 2.0 ** -5    # the power-of-two activation scale of the half-step case
W_STEP = 2.0 ** -6  # and the weights' (absmax 127 * W_STEP per channel)


def _act(rng, shape, kind):
    """(x, s_x): random N(0, 1) values at absmax/127, or integers and
    half-integers times STEP (some past ±127.5 steps, so the clip runs)."""
    if kind == "random":
        x = rng.standard_normal(shape).astype(np.float32)
        return x, float(np.abs(x).max()) / 127.0
    j = rng.integers(-130, 130, shape).astype(np.float32)
    half = rng.random(shape) < 0.5
    return ((j + 0.5 * half) * STEP).astype(np.float32), STEP


def _weights(rng, shape, out_axis, kind):
    """Random weights, or half-integer multiples of W_STEP whose absmax is
    127 * W_STEP in every output channel (so s_w == W_STEP exactly)."""
    if kind == "random":
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    w = (rng.integers(-127, 127, shape) + 0.5).astype(np.float32)
    idx = [0] * len(shape)
    idx[out_axis] = slice(None)
    w[tuple(idx)] = 127.0
    return (w * W_STEP).astype(np.float32)


def _pair(x, dtype):
    return (jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_bits(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32) if got.dtype ==
                                  np.float32 else got,
                                  want.view(np.int32) if want.dtype ==
                                  np.float32 else want)


def _q8_pair(jx, tx, s_x):
    """(JAX int8, port int8) of an activation."""
    return jq._q8(jx, s_x), kq.quantize_int8(tx, s_x)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_intercept_equals_jax(stride, dtype, kind):
    rng = np.random.default_rng(10 + stride)
    x, s_x = _act(rng, (2, 9, 9, 6), kind)
    w = _weights(rng, (5, 5, 6, 7), 3, kind)
    jx, tx = _pair(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jqx, tqx = _q8_pair(jx, tx, s_x)
    _assert_bits(tqx, jqx)
    s_w = jq._w_scales(jw, 3)
    t_sw = tq.weight_scales(tw, 3)
    _assert_bits(t_sw, s_w)
    jqw = jq._q8(jw, s_w)
    tqw = kq.quantize_int8(tw, t_sw, axis=3)
    _assert_bits(tqw, jqw)
    sums = lax.conv_general_dilated(
        jqx, jqw, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    _assert_bits(kq.int8_conv(tqx, tqw, None, stride, "SAME", torch.int32),
                 sums)
    with jq.quantized({"c": s_x}):
        want = jq.intercept_conv2d("c", jx, jw, stride, "SAME")
    with tq.quantized({"c": s_x}):
        got = tq.intercept_conv2d("c", tx, tw, stride, "SAME")
    assert got.dtype == tx.dtype
    _assert_bits(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_deconv2d_phase_route_equals_jax(dtype, kind):
    """Stride-2 SAME k = 5: JAX's int8 ``conv_transpose`` against the
    port's one stride-1 Q2 conv on the phase filter of the int8 taps."""
    rng = np.random.default_rng(20)
    x, s_x = _act(rng, (2, 4, 5, 6), kind)
    w = _weights(rng, (5, 5, 7, 6), 2, kind)  # (k, k, O, I)
    jx, tx = _pair(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    s_w = jq._w_scales(jw, 2)
    jqx = jq._q8(jx, s_x)
    jqw = jq._q8(jw, s_w[None, None, :, None])
    sums = lax.conv_transpose(
        jqx, jqw, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        transpose_kernel=True, preferred_element_type=jnp.int32)
    # the port's route: the whole filter per o, then the phase taps
    from graphical_gan_tpu_torch.ops.phase_deconv import (
        _phase_kernel, _phase_plan)
    tqw = kq.quantize_int8(tw, tq.weight_scales(tw, 2), axis=2)
    _assert_bits(tqw, jqw)
    big = _phase_kernel(tqw, 5)[0].contiguous()
    pl, pr = _phase_plan(5)[:2]
    out4 = kq.int8_conv(kq.quantize_int8(tx, s_x), big, None, 1,
                        ((pl, pr), (pl, pr)), torch.int32)
    b, h, wd = out4.shape[:3]
    port_sums = out4.reshape(b, h, wd, 2, 2, 7).permute(0, 1, 3, 2, 4, 5)
    _assert_bits(port_sums.reshape(b, 2 * h, 2 * wd, 7).contiguous(), sums)
    with jq.quantized({"d": s_x}):
        want = jq.intercept_deconv2d("d", jx, jw, 2, "SAME")
    with tq.quantized({"d": s_x}):
        got = tq.intercept_deconv2d("d", tx, tw, 2, "SAME")
    _assert_bits(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_intercept_equals_jax(dtype, kind):
    rng = np.random.default_rng(30)
    x, s_x = _act(rng, (9, 13), kind)
    w = _weights(rng, (13, 5), 1, kind)
    jx, tx = _pair(x, dtype)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    s_w = jq._w_scales(jw, 1)
    sums = lax.dot_general(jq._q8(jx, s_x), jq._q8(jw, s_w),
                           (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    tqw = kq.quantize_int8(tw, tq.weight_scales(tw, 1), axis=1)
    port = kq.int8_conv(kq.quantize_int8(tx, s_x).reshape(9, 1, 1, 13),
                        tqw.reshape(1, 1, 13, 5), None, 1, "VALID",
                        torch.int32)
    _assert_bits(port.reshape(9, 5), sums)
    with jq.quantized({"l": s_x}):
        want = jq.intercept_linear("l", jx, jw)
    with tq.quantized({"l": s_x}):
        got = tq.intercept_linear("l", tx, tw)
    _assert_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layers_with_bias_and_act_equal_jax(dtype):
    """Through the layer functions: conv2d with a leaky ReLU after its
    bias, deconv2d with its bias, and linear on a 3-D input (its 2-D view
    is what both intercept)."""
    rng = np.random.default_rng(40)
    x, s_x = _act(rng, (2, 8, 8, 3), "random")
    x3, s_3 = _act(rng, (3, 5, 16), "random")
    params = {"c.Filters": _weights(rng, (5, 5, 3, 4), 3, "random"),
              "c.Biases": rng.standard_normal(4).astype(np.float32),
              "d.Filters": _weights(rng, (5, 5, 2, 4), 2, "random"),
              "d.Biases": rng.standard_normal(2).astype(np.float32),
              "l.W": _weights(rng, (16, 6), 1, "random"),
              "l.b": rng.standard_normal(6).astype(np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jx, tx = _pair(x, dtype)
    jx3, tx3 = _pair(x3, dtype)
    scales = {"c": s_x, "l": s_3}

    def jf(xx, xx3):
        h = jax_conv2d("c", 3, 4, 5, xx, stride=2, act="leaky_relu")
        with_d = jax_deconv2d("d", 4, 2, 5, h)
        return h, with_d, jax_linear("l", 16, 6, xx3)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    rec = {}
    # the deconv's input scale comes from the conv's output
    with jq.calibrating(rec):
        registry.apply(jf, jparams, KEY, jx, jx3)
    scales["d"] = rec["d"] / 127.0
    with jq.quantized(scales):
        want = registry.apply(jf, jparams, KEY, jx, jx3)
    with tq.quantized(scales):
        h = conv2d(tparams, "c", tx, stride=2, act="leaky_relu")
        got = (h, deconv2d(tparams, "d", h), linear(tparams, "l", tx3))
    for g, w in zip(got, want):
        _assert_bits(g, w)


def test_plain_q2_against_numpy_int64():
    rng = np.random.default_rng(50)
    x = rng.integers(-127, 128, (2, 7, 6, 5)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 5, 4)).astype(np.int8)
    got = kq.int8_conv(torch.from_numpy(x), torch.from_numpy(w), None, 2,
                       ((1, 2), (0, 1)), torch.int32).numpy()
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 2), (0, 1), (0, 0)))
    oh, ow = (xp.shape[1] - 3) // 2 + 1, (xp.shape[2] - 3) // 2 + 1
    want = np.zeros((2, oh, ow, 4), np.int64)
    for i in range(3):
        for j in range(3):
            patch = xp[:, i:i + 2 * oh:2, j:j + 2 * ow:2, :]
            want += np.einsum("bhwc,co->bhwo", patch, w[i, j].astype(np.int64))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the largest sums stay exact: every product 127 * 127 at K = 5 * 5 * 512
    xm = torch.full((1, 5, 5, 512), 127, dtype=torch.int8)
    wm = torch.full((5, 5, 512, 1), -127, dtype=torch.int8)
    assert int(kq.int8_conv(xm, wm, None, 1, "VALID", torch.int32)) \
        == -127 * 127 * 5 * 5 * 512
    factor = torch.tensor([0.5], dtype=torch.float32)
    out = kq.int8_conv(xm, wm, factor, 1, "VALID", torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert float(out) == float(torch.tensor(-127 * 127 * 5 * 5 * 512 * 0.5,
                                            dtype=torch.bfloat16))


def test_q2_overflow_check_raises():
    k_max = kq.MAX_K
    assert k_max * 127 * 127 < 2 ** 31 <= (k_max + 1) * 127 * 127
    cin = k_max // 9 + 1  # 3 x 3 taps past the bound
    x = torch.zeros((1, 3, 3, cin), dtype=torch.int8)
    w = torch.zeros((3, 3, cin, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow the int32 sums"):
        kq.int8_conv(x, w, None, 1, "SAME", torch.int32)
    ok = torch.zeros((1, 1, 1, k_max), dtype=torch.int8)
    kq.int8_conv(ok, torch.zeros((1, 1, k_max, 1), dtype=torch.int8), None,
                 1, "VALID", torch.int32)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 x and w"):
        kq.int8_conv(x.float(), torch.zeros((1, 1, 3, 2), dtype=torch.int8),
                     None, 1, "VALID", torch.int32)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        kq.int8_conv(x, torch.zeros((1, 1, 3, 2), dtype=torch.int8), None, 3,
                     "VALID", torch.int32)
    with pytest.raises(ValueError, match="factor"):
        kq.int8_conv(x, torch.zeros((1, 1, 3, 2), dtype=torch.int8), None, 1,
                     "VALID", torch.float32)
    with pytest.raises(ValueError, match="scales"):
        kq.quantize_int8(torch.zeros(3, 4), torch.ones(3), axis=1)
    kernels_launched = kq.int8_conv.launches + kq.quantize_int8.launches
    kq.quantize_int8(torch.zeros(3, 4), 0.5)
    assert kq.int8_conv.launches + kq.quantize_int8.launches \
        == kernels_launched  # the plain versions count no launch


def test_contexts_do_not_nest_and_are_inert_by_default():
    with tq.calibrating({}):
        with pytest.raises(RuntimeError, match="already active"):
            with tq.quantized({"x": 1.0}):
                pass
    with tq.quantized({}):
        with pytest.raises(RuntimeError, match="already active"):
            with tq.calibrating({}):
                pass
    assert tq.intercept_conv2d("c", None, None, 1, "SAME") is None
    assert tq.intercept_deconv2d("d", None, None, 2, "SAME") is None
    assert tq.intercept_linear("l", None, None) is None


def test_missing_scale_raises_with_its_message():
    params = {"c.Filters": torch.ones(3, 3, 2, 4),
              "c.Biases": torch.zeros(4)}
    with tq.quantized({}):
        with pytest.raises(KeyError, match="no calibrated activation scale "
                                           "for layer 'c'"):
            conv2d(params, "c", torch.ones(1, 4, 4, 2))


def test_calibration_refuses_traced_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        x = mode.from_tensor(torch.ones(2, 3))
    with tq.calibrating({}):
        with pytest.raises(RuntimeError, match="eagerly"):
            tq.intercept_linear("l", x, torch.ones(3, 2))


def test_weights_quantized_once_per_cache():
    """A sampler's weight cache quantizes each filter at the first call and
    reuses it while the filter is the same tensor."""
    params = {"l.W": torch.randn(8, 4), "l.b": torch.zeros(4)}
    cache = {}
    x = torch.randn(5, 8)
    before = kq.quantize_int8.launches
    with tq.quantized({"l": 0.05}, cache):
        a = linear(params, "l", x)
    wq = cache["l"][2]
    with tq.quantized({"l": 0.05}, cache):
        b = linear(params, "l", x)
    assert cache["l"][2] is wq
    assert torch.equal(a, b)
    params["l.W"] = params["l.W"] * 2  # another tensor: quantized anew
    with tq.quantized({"l": 0.05}, cache):
        linear(params, "l", x)
    assert cache["l"][2] is not wq
    assert kq.quantize_int8.launches == before  # CPU: no kernel launches


def test_int8_deconv_under_inference_mode_leaves_the_phase_route_trainable():
    """The int8 deconv builds the phase plan's tap index under the
    sampler's ``torch.inference_mode``; the index is cached per device, so
    it must not be an inference tensor that a later differentiable phase
    deconv saves for backward."""
    from graphical_gan_tpu_torch.ops import phase_deconv
    phase_deconv._tap_index.cache_clear()
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.standard_normal((1, 3, 3, 2), np.float32))
    w = torch.from_numpy(_weights(rng, (5, 5, 4, 2), 2, "random"))
    with torch.inference_mode(), tq.quantized({"d": 0.05}):
        tq.intercept_deconv2d("d", x, w, 2, "SAME")
    wg = w.clone().requires_grad_(True)
    phase_deconv.conv_transpose_phase(x, wg).sum().backward()
    assert wg.grad is not None and torch.isfinite(wg.grad).all()
