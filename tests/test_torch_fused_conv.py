"""K1's plain version (graphical_gan_tpu_torch/ops/kernels/fused_conv.py)
against the JAX ``fused_conv2d_bias_act`` Pallas kernel, run in interpret
mode on the CPU as tests/test_pallas_conv.py runs it, over that file's
cases. The CUDA kernel itself is held against this plain version on the
card by chip_smoke.py.

Tolerances: f32 atol/rtol 1e-4 (test_pallas_conv.py's); bf16 max |Δ|
within 2e-2 of max(1, max |ref|).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas.fused_conv import (
    _same_pads, fused_conv2d_bias_act as jax_fused)
from graphical_gan_tpu_torch.ops.kernels import fused_conv

CASES = [
    # (B, H, W, Cin, Cout, K, stride, padding): test_pallas_conv.py's cases
    (4, 32, 32, 3, 16, 5, 2, "SAME"),
    (4, 16, 16, 16, 32, 5, 2, "SAME"),
    (2, 7, 7, 8, 16, 5, 2, "SAME"),
    (2, 9, 9, 8, 8, 3, 1, "SAME"),
    (2, 12, 12, 8, 8, 5, 2, "VALID"),
    (2, 8, 8, 8, 24, 1, 1, "SAME"),
]


def _inputs(case, seed=0):
    b, h, w_, cin, cout, k, _, _ = case
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w_, cin).astype("float32")
    w = (rng.randn(k, k, cin, cout) * 0.2).astype("float32")
    bias = rng.randn(cout).astype("float32")
    return x, w, bias


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_f32(case, act):
    x, w, bias = _inputs(case)
    s, pad = case[6], case[7]
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias), s, pad, act))
    got = fused_conv.fused_conv2d_bias_act(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), s,
        pad, act)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES[:3])
def test_plain_matches_pallas_bf16(case):
    x, w, bias = _inputs(case, seed=1)
    s, pad = case[6], case[7]
    want = np.asarray(jax_fused(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(bias), s, pad, "leaky_relu"),
                      np.float32)
    got = fused_conv.fused_conv2d_bias_act(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(bias), s, pad, "leaky_relu")
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.float().numpy() - want).max()) / scale < 2e-2


@pytest.mark.parametrize("size,k,s", [(32, 5, 2), (16, 5, 2), (8, 5, 2),
                                      (7, 5, 2), (9, 3, 1), (8, 1, 1)])
def test_same_pads_match(size, k, s):
    assert fused_conv.same_pads(size, k, s) == _same_pads(size, k, s)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, w, bias = _inputs(CASES[2])
    before = fused_conv.fused_conv2d_bias_act.launches
    fused_conv.fused_conv2d_bias_act(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(bias), 2, "SAME", None)
    assert fused_conv.fused_conv2d_bias_act.launches == before


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fused_conv.fused_conv2d_bias_act(torch.zeros(1, 4, 4, 3),
                                         torch.zeros(5, 5, 2, 8),
                                         torch.zeros(8))
    with pytest.raises(ValueError):
        fused_conv.out_size(8, 5, 2, "FULL")
