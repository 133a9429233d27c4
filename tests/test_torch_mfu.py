"""The port's MFU tool (graphical_gan_tpu_torch/tools/mfu.py) on the CPU:
``flops_per_iter`` (FlopCounterMode over one step on fake CPU tensors)
equals a count worked out from the shapes of every convolution and GEMM
the same step runs on real tensors, doubles exactly with the batch, and
does not depend on the compute dtype; the MFU arithmetic, the
``GGAN_PEAK_FLOPS`` override, ``null`` on an unknown card; the CLI on the
CPU and its refusal without a card.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.tools import mfu
from graphical_gan_tpu_torch.train.step import make_train_step
from _torch_threads import one_thread  # noqa: F401

SMALL = {"gan": dict(dim=8, batch_size=8),
         "gmgan": dict(dim=8, batch_size=8, n_coms=5),
         "ssgan": dict(dim=4, batch_size=2, seq_len=3)}


class _ShapeCount(TorchDispatchMode):
    """2·(multiply-adds) of each convolution and GEMM, from its operands'
    and result's shapes: a conv's output element takes Cin/groups·k·k
    products (a transposed conv's input element as many); each gradient a
    convolution_backward computes costs what its forward does."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.conv_weights = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name == "aten.convolution":
            x, w, transposed = args[0], args[1], args[6]
            taps = w.shape[1] * math.prod(w.shape[2:])
            self.flops += 2 * (x if transposed else out).numel() * taps
            if not transposed:
                self.conv_weights.add(tuple(w.shape))
        elif name == "aten.convolution_backward":
            go, x, w, transposed, mask = (args[0], args[1], args[2],
                                          args[7], args[10])
            taps = w.shape[1] * math.prod(w.shape[2:])
            fwd = 2 * (x if transposed else go).numel() * taps
            self.flops += fwd * (int(mask[0]) + int(mask[1]))
        elif name in ("aten.mm", "aten.addmm"):
            a, b = args[-2], args[-1]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif name == "aten.bmm":
            a, b = args
            self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] \
                * b.shape[2]
        return out


@pytest.fixture(scope="module")
def counts():
    """flops_per_iter of each SMALL config, counted once."""
    return {f: mfu.flops_per_iter("float32", f, **kw)
            for f, kw in SMALL.items()}


def _shape_count(family, **overrides):
    cfg, model = mfu.family_model(family, "float32", **overrides)
    step, init_state = make_train_step(model)
    state = init_state(model.init(0, "cpu"))
    n = (1 + cfg.critic_iters) * cfg.batch_size
    data = to_device(mfu.family_data(family, cfg, n=n), "cpu")
    gen = torch.Generator().manual_seed(1)
    raw = sample_batches(data, 1 + cfg.critic_iters, cfg.batch_size, gen)
    with _ShapeCount() as counter:
        step(state, raw, True, gen)
    filters = {tuple(p.shape) for k, p in state.params.items()
               if k.endswith(".Filters") and ("Extractor" in k
                                              or "Discriminator" in k)
               and p.ndim == 4}
    return counter, filters


@pytest.mark.parametrize("family", sorted(SMALL))
def test_flops_per_iter_equals_the_shape_count(family, counts):
    counter, filters = _shape_count(family, **SMALL[family])
    assert counts[family] == counter.flops > 0
    # the E and D convs are among those counted (HWIO -> OIHW)
    assert {(o, i, h, w) for h, w, i, o in filters} <= counter.conv_weights


@pytest.mark.parametrize("family", sorted(SMALL))
def test_flops_per_iter_doubles_with_the_batch(family, counts):
    small = SMALL[family]
    big = dict(small, batch_size=2 * small["batch_size"])
    assert mfu.flops_per_iter("float32", family, **big) \
        == 2 * counts[family]


def test_flops_per_iter_does_not_depend_on_dtype(counts):
    assert mfu.flops_per_iter("bfloat16", "gan", **SMALL["gan"]) \
        == counts["gan"]


def test_h100_peaks_are_the_datasheet_dense_rates():
    assert mfu.PEAK["NVIDIA H100 80GB HBM3"] == {"float32": 66.9e12,
                                                 "bfloat16": 989.4e12,
                                                 "int8": 1979e12}


def test_mfu_arithmetic(monkeypatch):
    monkeypatch.delenv("GGAN_PEAK_FLOPS", raising=False)
    rec = mfu.mfu_record("gan", "bfloat16", 294.1e9, 0.1,
                         "NVIDIA H100 80GB HBM3", 2e9)
    assert rec["metric"] == "cifar10_wali_gp_mfu"
    assert rec["flops_source"] == "cpu flop counter"
    assert rec["achieved_tflops"] == pytest.approx(2.941)
    assert rec["peak_tflops"] == pytest.approx(989.4)
    assert rec["mfu"] == pytest.approx(2.941e12 / 989.4e12)
    f32 = mfu.mfu_record("ssgan", "float32", 1e12, 0.5,
                         "NVIDIA H100 80GB HBM3", 2e9)
    assert f32["metric"] == "ssgan_moving_mnist_local_ep_mfu"
    assert f32["mfu"] == pytest.approx(2e12 / 66.9e12)


def test_peak_override_and_unknown_card(monkeypatch):
    monkeypatch.delenv("GGAN_PEAK_FLOPS", raising=False)
    rec = mfu.mfu_record("gmgan", "float32", 1e9, 1.0, "some other card",
                         2e9)
    assert rec["peak_tflops"] is None and rec["mfu"] is None
    assert rec["metric"] == "gmgan_cifar10_local_ep_mfu"
    monkeypatch.setenv("GGAN_PEAK_FLOPS", "2e12")
    rec = mfu.mfu_record("gmgan", "float32", 1e9, 1.0, "some other card",
                         2e9)
    assert rec["peak_tflops"] == 2.0 and rec["mfu"] == pytest.approx(5e-4)
    rec = mfu.mfu_record("gan", "float32", 1e9, 1.0,
                         "NVIDIA H100 80GB HBM3", 2e9)
    assert rec["peak_tflops"] == 2.0  # the override wins over the table


def test_cli_on_the_cpu(monkeypatch, capsys, counts):
    monkeypatch.setenv("GGAN_PEAK_FLOPS", "1e12")
    rec = mfu.main(["--family", "gan", "--dtype", "float32", "--dim", "8",
                    "--batch-size", "8", "--data-rows", "32", "--rounds",
                    "1", "--iters", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert rec["device_kind"] == "cpu"
    assert rec["flops_per_iter"] == counts["gan"]
    assert rec["sec_per_iter"] > 0
    assert rec["mfu"] == pytest.approx(
        rec["flops_per_iter"] / rec["sec_per_iter"] / 1e12)


def test_time_train_counts_its_iterations(tmp_path):
    tr = mfu.make_trainer("gan", "float32", str(tmp_path), "cpu",
                          data_rows=32, **SMALL["gan"])
    assert np.isfinite(mfu.time_train(tr, 2))
    assert tr.state.step == 2


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mfu.main(["--family", "gan", "--dim", "8", "--batch-size", "8"])
