"""K3, the port's ``conv_gemm`` (``graphical_gan_tpu_torch/ops/kernels/
conv_gemm.py``), on the CPU where it computes its plain version, against the
JAX ``conv_gemm`` as the JAX package's own tests run it on the CPU (Pallas
interpret mode, ``conv_gemm.py:56``), both variants, from the same numpy
inputs.

Tolerances: f32 atol 1e-3, as ``tests/test_conv_gemm.py:28`` holds the
JAX kernel to XLA; bf16 max |Δ| < 2e-2 of max(1, max |ref|) (bf16 output
rounding); the geometry is exact. Shapes: the smaller JAX-test shapes (the
stem-like Cin = 8 and the odd H = 12), and a non-square input, where JAX's
``phase_stack`` takes the height's span for both axes and cannot be
compared, against an independent tap-by-tap sum over the port's
``phase_stack``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphical_gan_tpu.ops.pallas.conv_gemm import conv_gemm as jax_conv_gemm
from graphical_gan_tpu.ops.pallas.conv_gemm import phase_stack as jax_phase
from graphical_gan_tpu_torch.ops import kernels
from graphical_gan_tpu_torch.ops.kernels.conv_gemm import (
    VARIANTS, conv_gemm, conv_gemm_plain, phase_stack)


def _inputs(b, h, w, cin, cout, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(5, 5, cin, cout) * 0.05).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,h,cin,cout", [(2, 32, 8, 128), (6, 12, 16, 128)])
def test_matches_jax_f32(b, h, cin, cout, variant):
    x, w, bias = _inputs(b, h, h, cin, cout, seed=0)
    want = np.asarray(jax_conv_gemm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(bias), variant=variant))
    got = conv_gemm(*map(torch.from_numpy, (x, w, bias)), variant=variant)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("leak", [0.2, None])
def test_matches_jax_bf16(leak):
    x, w, bias = _inputs(2, 16, 16, 64, 128, seed=1)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, bias)]
    want = np.asarray(jax_conv_gemm(*j, leak=leak), np.float32)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, bias)]
    got = conv_gemm(*t, leak=leak)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() / scale < 2e-2


def test_batch_blocking_changes_nothing():
    """``b_block`` and ``n_block`` are the TPU's tiling hints: the same
    bits for every value (``test_conv_gemm_batch_blocking_equivalence``)."""
    x, w, bias = map(torch.from_numpy, _inputs(8, 16, 16, 64, 128, seed=2))
    whole = conv_gemm(x, w, bias, b_block=8)
    for kw in (dict(b_block=2), dict(b_block=3, n_block=64)):
        assert torch.equal(conv_gemm(x, w, bias, **kw), whole)


@pytest.mark.parametrize("h", [16, 12, 9])
def test_phase_stack_matches_jax_on_square(h):
    x = np.random.RandomState(3).randn(2, h, h, 4).astype(np.float32)
    want = np.asarray(jax_phase(jnp.asarray(x), 5, 2))
    got = phase_stack(torch.from_numpy(x), 5, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def _taps_sum(x, w, bias, leak):
    """The TPU kernel's algorithm in numpy: tap (kh, kw) reads phase
    (kh % 2, kw % 2) of ``phase_stack`` at offset (kh // 2, kw // 2)."""
    xp = phase_stack(torch.from_numpy(x), 5, 2).numpy().astype(np.float64)
    oh, ow = -(-x.shape[1] // 2), -(-x.shape[2] // 2)
    acc = np.zeros((x.shape[0], oh, ow, w.shape[3]))
    for kh in range(5):
        for kw in range(5):
            win = xp[(kh % 2) * 2 + kw % 2][:, kh // 2:kh // 2 + oh,
                                            kw // 2:kw // 2 + ow]
            acc += win @ w[kh, kw].astype(np.float64)
    acc += bias
    return np.where(acc >= 0, acc, leak * acc) if leak is not None else acc


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(4, 16, 12, 64, 128), (3, 9, 14, 3, 70)])
def test_non_square_against_taps_sum(shape, variant):
    """H != W: per-axis spans and pads (the reference fault, ADVICE.md:3,
    is not copied)."""
    x, w, bias = _inputs(*shape, seed=4)
    for leak in (0.2, None):
        got = conv_gemm(*map(torch.from_numpy, (x, w, bias)), leak=leak,
                        variant=variant)
        np.testing.assert_allclose(got.numpy(), _taps_sum(x, w, bias, leak),
                                   atol=1e-3, rtol=0)


def test_cpu_launches_no_kernel_and_refuses_bad_arguments():
    kernels.reset_launches()
    x, w, bias = map(torch.from_numpy, _inputs(2, 8, 8, 8, 16, seed=5))
    for v in VARIANTS:
        conv_gemm(x, w, bias, variant=v)
    assert all(n == 0 for n in kernels.launches().values())
    assert torch.equal(conv_gemm(x, w, bias), conv_gemm_plain(x, w, bias))
    with pytest.raises(ValueError, match="variant"):
        conv_gemm(x, w, bias, variant="direct")
    with pytest.raises(ValueError, match="NHWC/HWIO"):
        conv_gemm(x, w[:, :, :4], bias)
