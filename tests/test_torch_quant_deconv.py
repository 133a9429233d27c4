"""The port's int8 transposed conv at every stride and padding
(``graphical_gan_tpu_torch/ops/quant.py: intercept_deconv2d``) against the
JAX package's (``graphical_gan_tpu/ops/quant.py: intercept_deconv2d``,
``lax.conv_transpose(..., transpose_kernel=True)`` on int8 operands) on
the CPU, over stride {1, 2, 3} x {SAME, VALID} x k {3, 4, 5}.

Given the same numpy x, w and s_x: the int32 sums of the port's route
(the zero-dilated int8 input, :func:`conv_transpose_pads`' edge pads, the
flipped HWIO filter, one stride-1 Q2 conv; stride 2 SAME the phase
route) equal JAX's ``conv_transpose`` with ``preferred_element_type=
int32``, and the dequantized outputs of the two intercepts are bit-equal,
in f32 and bf16. ``deconv2d`` inside ``quantized(...)`` computes for
every case (it raised for all but stride 2 SAME before) and adds its
bias as JAX's layer does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from graphical_gan_tpu.ops import quant as jq
from graphical_gan_tpu_torch.ops import quant as tq
from graphical_gan_tpu_torch.ops.conv import deconv2d
from graphical_gan_tpu_torch.ops.kernels import quant as kq

from _torch_threads import one_thread  # noqa: F401

CASES = [(s, p, k) for s in (1, 2, 3) for p in ("SAME", "VALID")
         for k in (3, 4, 5)]


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.is_floating_point() else a.numpy()
    else:
        a = np.asarray(a)
        a = a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
    return a.view(np.int32) if a.dtype == np.float32 else a


def _inputs(stride, k, dtype):
    rng = np.random.default_rng(100 * stride + k)
    x = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, 7, 6))).astype(np.float32)
    s_x = float(np.abs(x).max()) / 127.0
    tdt = getattr(torch, dtype)
    return (x, w, s_x, jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(tdt))


@pytest.mark.parametrize("stride,padding,k", CASES)
def test_int32_sums_equal_jax(stride, padding, k):
    x, w, s_x, jx, tx = _inputs(stride, k, "float32")
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    s_w = jq._w_scales(jw, 2)
    sums = lax.conv_transpose(
        jq._q8(jx, s_x), jq._q8(jw, s_w[None, None, :, None]),
        (stride, stride), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        transpose_kernel=True, preferred_element_type=jnp.int32)
    tqw = kq.quantize_int8(tw, tq.weight_scales(tw, 2), axis=2)
    hwio = tqw.flip(0, 1).permute(0, 1, 3, 2).contiguous()
    pads = tq.conv_transpose_pads(k, stride, padding)
    xd = tq.dilate_rows_cols(kq.quantize_int8(tx, s_x), stride)
    port = kq.int8_conv(xd, hwio, None, 1, (pads, pads), torch.int32)
    want = np.asarray(sums)
    assert tuple(port.shape) == want.shape
    if padding == "VALID":
        assert want.shape[1] == 5 * stride + max(k - stride, 0)
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,padding,k", CASES)
def test_intercept_bits_equal_jax(stride, padding, k, dtype):
    x, w, s_x, jx, tx = _inputs(stride, k, dtype)
    with jq.quantized({"d": s_x}):
        want = jq.intercept_deconv2d("d", jx, jnp.asarray(w), stride,
                                     padding)
    with tq.quantized({"d": s_x}):
        got = tq.intercept_deconv2d("d", tx, torch.from_numpy(w), stride,
                                    padding)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (1, "VALID"),
                                            (2, "VALID"), (3, "SAME"),
                                            (3, "VALID")])
def test_deconv2d_layer_computes_inside_quantized(stride, padding):
    """The layer (bias included) under an int8 context: equal to JAX's
    intercept plus the bias in x's dtype, where it raised before."""
    x, w, s_x, jx, tx = _inputs(stride, 5, "float32")
    bias = np.random.default_rng(7).standard_normal(7).astype(np.float32)
    params = {"d.Filters": torch.from_numpy(w),
              "d.Biases": torch.from_numpy(bias)}
    with tq.quantized({"d": s_x}):
        got = deconv2d(params, "d", tx, stride=stride, padding=padding)
    with jq.quantized({"d": s_x}):
        want = jq.intercept_deconv2d("d", jx, jnp.asarray(w), stride,
                                     padding) + jnp.asarray(bias)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_weight_cache_reuses_the_flipped_filter():
    x, w, s_x, _, tx = _inputs(3, 4, "float32")
    cache = {}
    tw = torch.from_numpy(w)
    with tq.quantized({"d": s_x}, cache):
        a = tq.intercept_deconv2d("d", tx, tw, 3, "VALID")
    entry = cache["d"][2]
    with tq.quantized({"d": s_x}, cache):
        b = tq.intercept_deconv2d("d", tx, tw, 3, "VALID")
    assert cache["d"][2] is entry
    assert torch.equal(a, b)
