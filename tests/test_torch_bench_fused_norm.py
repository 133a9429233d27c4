"""The port's K2 bench tool (``graphical_gan_tpu_torch/tools/
bench_fused_norm.py``, the counterpart of the JAX package's
``tools/bench_pallas.py``) on the CPU: ``--device cpu`` times the three
arms at its toy shape on the host's clock (one record per dtype, every
field), the arms compute one function, the shapes are the JAX tool's, the
bound counts x and y once, and without a card the default device raises.
"""

import numpy as np
import pytest
import torch

from graphical_gan_tpu.tools import bench_pallas as jax_bench
from graphical_gan_tpu_torch.tools import bench_fused_norm as bench
from _torch_threads import one_thread  # noqa: F401

FIELDS = {"metric", "shape", "rows", "channels", "dtype", "bound_ms",
          "bound_by", "card", "clock", "kernel_vs_plain",
          "kernel_vs_library"} | {f"{arm}_ms" for arm in bench.ARMS}


def test_cpu_run_prints_every_record(capsys):
    recs = bench.main(["--device", "cpu", "--dtype", "float32,bfloat16"])
    assert [r["dtype"] for r in recs] == ["float32", "bfloat16"]
    for rec in recs:
        assert set(rec) == FIELDS
        assert rec["clock"] == "host" and rec["card"] == "cpu"
        assert all(rec[f"{a}_ms"] > 0 for a in bench.ARMS)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arms_compute_one_function(dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand((64, 8), generator=gen) * 2 - 1).to(dtype)
    scale = torch.rand((8,), generator=gen) + 0.5
    offset = torch.randn((8,), generator=gen)
    outs = {arm: fn(x).float().numpy()
            for arm, fn in bench._arms(scale, offset).items()}
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for arm in ("plain", "library"):
        np.testing.assert_allclose(outs[arm], outs["kernel"], rtol=tol,
                                   atol=tol)


def test_shapes_are_the_jax_tools():
    assert bench.SHAPES == jax_bench.SHAPES


def test_bound_counts_x_and_y_once():
    assert bench.bound_ms(1000, 10, 4) == pytest.approx(
        (2 * 1000 * 10 * 4 + 80) / 3.35e12 * 1e3)


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
