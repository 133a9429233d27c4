"""The port's K3 bench tool (``graphical_gan_tpu_torch/tools/
bench_conv_kernel.py``) and its timer's input rotation (``tools/timing.py``)
on the CPU: the record of one small shape with a stub timer (its fields,
the JAX tool's renamed, each arm's relative error, exactly 0 here where
all three arms compute the plain version, and the route each K3 arm would
take on the card), the tool's refusal without a
card, and how many argument copies the timer rotates over for a given L2.
"""

import json

import pytest
import torch

from graphical_gan_tpu_torch.tools import bench_conv_kernel as bench
from graphical_gan_tpu_torch.tools.timing import rotation_copies, time_ms

FIELDS = {"shape", "B", "H", "Cin", "Cout", "dtype", "flops", "best",
          "best_k3_vs_library", "device_kind", "card", "k3_taps_route",
          "k3_im2col_route", "reps"} | {
    f"{arm}_{f}" for arm in bench.ARMS for f in ("rel_maxerr", "us",
                                                 "tflops")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_record_of_one_shape(dtype, capsys):
    times = {"library": 2.0, "k3_taps": 4.0, "k3_im2col": 1.0}
    calls = []

    def stub(fn, args):
        calls.append(fn.__name__)
        return times[{"library": "library", "taps": "k3_taps",
                      "im2col": "k3_im2col"}[fn.__name__]]

    (rec,) = bench.run([("tiny", 2, 8, 16, 24)], dtype, device="cpu",
                       timer=stub)
    assert set(rec) == FIELDS
    assert calls == ["library", "taps", "im2col"]
    assert json.loads(capsys.readouterr().out.strip()) == rec
    oh = 4
    assert rec["flops"] == 2 * 2 * oh * oh * 24 * 25 * 16
    assert rec["k3_im2col_us"] == 1000.0
    assert rec["k3_taps_tflops"] == pytest.approx(rec["flops"] / 4e-3 / 1e12)
    assert rec["best"] == "k3_im2col" and rec["best_k3_vs_library"] == 2.0
    # the routes the card would take: K3a's TMA mainloop in bf16 (Cin 16,
    # Cout 24 are multiples of 8), K1's kernels otherwise
    taps_path = "tma" if dtype == "bfloat16" else "fma"
    im2col_path = "wgmma" if dtype == "bfloat16" else "fma"
    assert rec["k3_taps_route"]["path"] == taps_path
    assert rec["k3_im2col_route"]["path"] == im2col_path
    # bf16: the library arm rounds after its own bias add; f32: all equal
    tol = 0.0 if dtype == "float32" else 2e-2
    for arm in bench.ARMS:
        assert 0.0 <= rec[f"{arm}_rel_maxerr"] <= tol


def test_tool_and_timer_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_ms(lambda: None, ())


@pytest.mark.parametrize("nbytes,l2,copies", [
    (10 * 2**20, 50 * 2**20, 10),    # 10 MB args: 10 sets hold 2 x 50 MB
    (30 * 2**20, 50 * 2**20, 4),     # ceil(100 / 30)
    (200 * 2**20, 50 * 2**20, 2),    # larger than L2: still two sets
    (0, 50 * 2**20, 2),              # no tensor arguments
])
def test_rotation_copies(nbytes, l2, copies):
    assert rotation_copies(nbytes, l2) == copies
