"""The port's phase-deconv bench tool (``graphical_gan_tpu_torch/tools/
bench_phase_deconv.py``) on the CPU: ``--device cpu`` times the three arms
at its toy shape on the host's clock (one record per dtype and pass, with
every field), the arms compute the same function, K1's bound at a phase
shape counts the taps inside the input only, the shape list is the JAX
tool's, and without a card the default device raises.
"""

import numpy as np
import pytest
import torch

from graphical_gan_tpu.tools import bench_phase_deconv as jax_bench
from graphical_gan_tpu_torch.tools import bench_phase_deconv as bench, mfu
from _torch_threads import one_thread  # noqa: F401

FIELDS = {"metric", "shape", "batch", "hw", "cin", "cout", "k", "dtype",
          "pass", "k1_bound_ms", "k1_bound_by", "card", "clock",
          "phase_speedup", "k1_vs_library"} | {
    f"{arm}_ms" for arm in bench.ARMS}


def test_cpu_run_prints_every_record(capsys):
    recs = bench.main(["--device", "cpu", "--reps", "1", "--rounds", "1"])
    assert [(r["dtype"], r["pass"]) for r in recs] == [
        ("float32", "fwd"), ("float32", "fwdbwd"), ("bfloat16", "fwd"),
        ("bfloat16", "fwdbwd")]
    for rec in recs:
        assert set(rec) == FIELDS
        assert rec["clock"] == "host" and rec["card"] == "cpu"
        assert all(rec[f"{a}_ms"] > 0 for a in bench.ARMS)
    assert len(capsys.readouterr().out.strip().splitlines()) == 4


def test_arms_compute_one_function():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 4, 8), generator=gen)
    w = torch.randn((5, 5, 3, 8), generator=gen)
    bias = torch.randn((3,), generator=gen)
    outs = {}
    for arm, (fn, filt) in bench._arms(x, w, bias).items():
        y = fn(x, filt)
        # the library arm leaves its output in phase-channel form
        if arm == "library":
            y = y.reshape(2, 4, 4, 2, 2, 3).permute(0, 1, 3, 2, 4, 5
                                                    ).reshape(2, 8, 8, 3)
        outs[arm] = y.numpy()
    for arm in ("phase", "library"):
        np.testing.assert_allclose(outs[arm], outs["cudnn"], rtol=2e-5,
                                   atol=2e-5)


def test_k1_bound_counts_taps_inside_the_input():
    # gen2: 4x4 input, a 3x3 window with pads (1, 1): 10 of 12 (output,
    # tap) pairs per axis land inside; 256 -> 4 * 128 channels, B 64
    ms, by = bench.k1_bound(64, 4, 256, 128, "float32")
    flops = 2.0 * 64 * 256 * 512 * 10 * 10
    assert by == "operations"
    assert ms == pytest.approx(
        flops / mfu.PEAK["NVIDIA H100 80GB HBM3"]["float32"] * 1e3)


def test_shapes_are_the_jax_tools():
    assert bench.SHAPES == jax_bench.SHAPES


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--shapes", "gen2"])
