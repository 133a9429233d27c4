"""The port's trace report (graphical_gan_tpu_torch/tools/trace_report.py)
and the trainer's profile hook (train/trainer.py, GGAN_PROFILE), on the
CPU: ``self_times`` equals the JAX tool's on the same synthetic events; a
synthetic CUDA trace attributes each kernel to the ops that launched it;
the hook writes a trace of exactly its window and leaves the parameters
bit-equal; the CLI's JSON line on that trace.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from graphical_gan_tpu.tools import trace_report as jax_tr
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.tools import trace_report as tr
from graphical_gan_tpu_torch.train.trainer import Trainer
from _torch_threads import one_thread  # noqa: F401


def _ev(name, ts, dur, pid=1, tid=1, **kw):
    return {"name": name, "ts": ts, "dur": dur, "ph": "X", "pid": pid,
            "tid": tid, **kw}


SELF_TIME_CASES = {
    "nesting": [_ev("parent", 0.0, 100.0), _ev("c1", 10.0, 20.0),
                _ev("c2", 40.0, 50.0), _ev("g", 50.0, 30.0)],
    "sequential_siblings": [_ev("a", 0.0, 10.0), _ev("b", 10.0, 5.0)],
    "concurrent_lanes": [_ev("opA", 0.0, 50.0, pid=1, tid=3),
                         _ev("opB", 1.0, 50.0, pid=2, tid=3)],
    "zero_duration": [_ev("p", 0.0, 10.0), _ev("z", 5.0, 0.0),
                      _ev("q", 10.0, 0.0), _ev("r", 10.0, 4.0)],
    "kernels_on_two_streams": [
        _ev("k1", 0.0, 5.0, pid=0, tid=7), _ev("k2", 5.0, 5.0, pid=0, tid=7),
        _ev("k3", 2.0, 6.0, pid=0, tid=13)],
}


@pytest.mark.parametrize("case", sorted(SELF_TIME_CASES))
def test_self_times_equal_jax(case):
    evs = SELF_TIME_CASES[case]
    got = [(e["name"], s) for e, s in tr.self_times(evs)]
    want = [(e["name"], s) for e, s in jax_tr.self_times(evs)]
    assert got == want
    # nothing double-counted: the self times of a lane sum to its span
    # of outermost events
    assert sum(s for _, s in got) == sum(
        e["dur"] for e in evs if not any(
            o is not e and o["pid"] == e["pid"] and o["tid"] == e["tid"]
            and o["ts"] <= e["ts"] and e["ts"] + e["dur"]
            <= o["ts"] + o["dur"] and o["dur"] > e["dur"] for o in evs))


@pytest.mark.parametrize("name, group", [
    ("conv_k1_fma_kernel<float>", "K1 fused_conv"),
    ("bn_stats_fused_kernel", "K2a bn_stats"),
    ("bn_apply_kernel", "K2b bn_apply"),
    ("sm90_xmma_dgrad_implicit_gemm", "transpose conv (cuDNN)"),
    ("ampere_sgemm_128x64_nn", "matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("elementwise_kernel", "other")])
def test_kernel_group(name, group):
    assert tr.kernel_group(name) == group


@pytest.mark.parametrize("kernel, chain, group", [
    ("conv_k1_wgmma", ["FusedConv2dBiasAct"], "K1 forward"),
    ("bn_bwd_fused_kernel", [], "K2c-d BN backward"),
    ("dgrad2d_alg1_1", ["aten::convolution_backward",
                        "FusedConv2dBiasActBackward"],
     "conv gradients (cuDNN)"),
    ("dgrad2d_alg1_1", ["aten::convolution_backward",
                        "ConvolutionBackward0"], "deconv backward"),
    ("vectorized_elementwise", ["aten::_foreach_add_"], "optimizer"),
    ("vectorized_elementwise", ["aten::add"], "other"),
    ("conv_k1_wgmma", ["cudaGraphLaunch"], "K1 forward"),
    ("dgrad2d_alg1_1", ["cudaGraphLaunch"], "graph replay"),
    ("sm80_xmma_dgrad_implicit_gemm", ["cudaGraphLaunch"], "graph replay"),
    ("sm80_xmma_dgrad_implicit_gemm", ["aten::mm"], "GEMMs")])
def test_op_group(kernel, chain, group):
    assert tr.op_group(kernel, chain) == group


def _synthetic_cuda_trace(path):
    """A Kineto-shaped trace: host ops and launches on pid 1 (the autograd
    thread, tid 2), kernels and a copy on the card's stream (pid 0, tid
    7); one kernel found through its launch's correlation id, one through
    its op's External id alone."""
    bwd = "autograd::engine::evaluate_function: FusedConv2dBiasActBackward"
    evs = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name":
                                                                 "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        _ev(bwd, 0.0, 200.0, tid=2, cat="cpu_op"),
        _ev("FusedConv2dBiasActBackward", 1.0, 190.0, tid=2, cat="cpu_op"),
        _ev("aten::convolution_backward", 10.0, 100.0, tid=2, cat="cpu_op",
            args={"External id": 5, "Input Dims": [[800, 32, 32, 32],
                                                   [800, 1, 67, 67],
                                                   [32, 1, 5, 5]]}),
        _ev("cudaLaunchKernel", 50.0, 5.0, tid=2, cat="cuda_runtime",
            args={"correlation": 77, "External id": 5}),
        _ev("FusedConv2dBiasAct", 300.0, 50.0, tid=2, cat="cpu_op",
            args={"External id": 9}),
        _ev("cudaLaunchKernel", 310.0, 5.0, tid=2, cat="cuda_runtime",
            args={"correlation": 78, "External id": 9}),
        _ev("aten::copy_", 400.0, 20.0, tid=2, cat="cpu_op",
            args={"External id": 11, "Input Dims": [[4], [4]]}),
        _ev("aten::conv_transpose2d", 600.0, 30.0, tid=1, cat="cpu_op",
            args={"External id": 12, "Input Dims": [[800, 256, 4, 4],
                                                    [256, 128, 5, 5]]}),
        _ev("cudaLaunchKernel", 610.0, 5.0, tid=1, cat="cuda_runtime",
            args={"correlation": 80, "External id": 12}),
        _ev("dgrad2d_alg1_1", 60.0, 400.0, pid=0, tid=7, cat="kernel",
            args={"correlation": 77}),
        _ev("conv_k1_fma", 460.0, 30.0, pid=0, tid=7, cat="kernel",
            args={"correlation": 78}),
        _ev("Memcpy DtoH", 490.0, 10.0, pid=0, tid=7, cat="gpu_memcpy",
            args={"correlation": 99, "External id": 11}),
        _ev("dgrad2d_alg1_1", 700.0, 100.0, pid=0, tid=7, cat="kernel",
            args={"correlation": 80}),
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": evs, "deviceProperties": [
            {"name": "NVIDIA H100 80GB HBM3"}]}, f)
    return path


def test_report_attributes_kernels_to_their_ops(tmp_path):
    path = _synthetic_cuda_trace(str(tmp_path / "x.trace.json.gz"))
    r = tr.report(str(tmp_path), iters=2)
    assert r["lanes"] == "device" and r["n_events"] == 4
    assert r["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert r["busy_ms"] == 0.54 and r["busy_ms_per_iter"] == 0.27
    assert {g["group"]: g["ms"] for g in r["by_kernel"]} == {
        "transpose conv (cuDNN)": 0.5, "K1 fused_conv": 0.03,
        "memcpy": 0.01}
    assert {g["group"]: g["ms"] for g in r["by_op"]} == {
        "conv gradients (cuDNN)": 0.4, "deconv forward": 0.1,
        "K1 forward": 0.03, "memcpy": 0.01}
    # one kernel, two launching ops: two rows
    dgrads = [o for o in r["top_ops"] if o["op"] == "dgrad2d_alg1_1"]
    assert [(o["ms"], o["group"]) for o in dgrads] == [
        (0.4, "conv gradients (cuDNN)"), (0.1, "deconv forward")]
    assert dgrads[1]["launched_by"] == ["aten::conv_transpose2d"]
    assert dgrads[1]["input_dims"][0] == [800, 256, 4, 4]
    top = r["top_ops"][0]
    assert top["op"] == "dgrad2d_alg1_1" and top["launched_by"] == [
        "aten::convolution_backward", "FusedConv2dBiasActBackward",
        "autograd::engine::evaluate_function: FusedConv2dBiasActBackward"]
    assert top["input_dims"][1] == [800, 1, 67, 67]
    # the copy has no launch call in the trace: its op comes from its
    # External id
    copy = next(o for o in r["top_ops"] if o["op"] == "Memcpy DtoH")
    assert copy["launched_by"] == ["aten::copy_"]
    assert path == tr.find_trace(str(tmp_path))


@pytest.mark.parametrize("warm", [False, True])
def test_report_attributes_graph_kernels_to_the_graph_launch(tmp_path,
                                                             warm):
    """The kernels of a CUDA graph's replay share the correlation id of
    the one ``cudaGraphLaunch`` and have no launching op: each is in K1's
    or K2's group by its name, else in the group of the same name's eager
    launches in the trace (``warm``: the graph's warm-up iteration, a
    deconv's backward and forward), else "graph replay" (a cuDNN implicit
    GEMM too), launched by the graph launch, and the groups add up to the
    busy time."""
    evs = [
        _ev("ggan::eval", 0.0, 40.0, tid=1, cat="cpu_op",
            args={"External id": 3}),
        _ev("cudaGraphLaunch", 10.0, 20.0, tid=1, cat="cuda_runtime",
            args={"correlation": 90, "External id": 3}),
        _ev("cudaGraphLaunch", 100.0, 20.0, tid=1, cat="cuda_runtime",
            args={"correlation": 91}),
    ]
    for corr, t0 in ((90, 50.0), (91, 500.0)):
        evs += [_ev("conv_k1_wgmma", t0, 30.0, pid=0, tid=7, cat="kernel",
                    args={"correlation": corr}),
                _ev("bn_bwd_fused_kernel", t0 + 30.0, 20.0, pid=0, tid=7,
                    cat="kernel", args={"correlation": corr}),
                _ev("dgrad2d_alg1_1", t0 + 50.0, 100.0, pid=0, tid=7,
                    cat="kernel", args={"correlation": corr}),
                _ev("sm80_xmma_fprop_implicit_gemm", t0 + 150.0, 50.0,
                    pid=0, tid=7, cat="kernel", args={"correlation": corr})]
    if warm:
        for ext, op, kernel, t0 in (
                (20, "ConvolutionBackward0", "dgrad2d_alg1_1", 2000.0),
                (21, "aten::conv_transpose2d",
                 "sm80_xmma_fprop_implicit_gemm", 3000.0)):
            evs += [_ev(op, t0, 40.0, tid=1, cat="cpu_op",
                        args={"External id": ext}),
                    _ev("cudaLaunchKernel", t0 + 10.0, 5.0, tid=1,
                        cat="cuda_runtime",
                        args={"correlation": ext, "External id": ext}),
                    _ev(kernel, t0 + 20.0, 100.0, pid=0, tid=7,
                        cat="kernel", args={"correlation": ext})]
    with gzip.open(str(tmp_path / "g.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": evs}, f)
    r = tr.report(str(tmp_path), iters=2)
    assert r["n_events"] == (10 if warm else 8)
    assert r["busy_ms"] == (0.6 if warm else 0.4)
    by_op = {g["group"]: g["ms"] for g in r["by_op"]}
    assert by_op == ({"deconv backward": 0.3, "deconv forward": 0.2,
                      "K1 forward": 0.06, "K2c-d BN backward": 0.04}
                     if warm else
                     {"graph replay": 0.3, "K1 forward": 0.06,
                      "K2c-d BN backward": 0.04})
    assert sum(by_op.values()) == pytest.approx(r["busy_ms"])
    assert sum(g["ms"] for g in r["by_kernel"]) == pytest.approx(
        r["busy_ms"])
    # the first launch sits inside an op, the second inside none
    dgrads = [o["launched_by"] for o in r["top_ops"]
              if o["op"] == "dgrad2d_alg1_1"]
    assert ["cudaGraphLaunch"] in dgrads
    assert ["cudaGraphLaunch", "ggan::eval"] in dgrads


def test_groups_by_name_takes_the_eager_group_of_most_time():
    """A name that eager launches served in two groups goes to the one it
    spent the most time in; replayed launches and the names they alone
    launched name no group; ``op_group`` takes the map for a replayed
    kernel of no name group only."""
    rows = [("dgrad", ["aten::conv_transpose2d"], 10.0),
            ("dgrad", ["ConvolutionBackward0"], 30.0),
            ("dgrad", ["cudaGraphLaunch"], 500.0),
            ("only_replayed", ["cudaGraphLaunch"], 5.0),
            ("conv_k1_fma", ["FusedConv2dBiasAct"], 1.0)]
    by_name = tr.groups_by_name(rows)
    assert by_name == {"dgrad": "deconv backward",
                       "conv_k1_fma": "K1 forward"}
    assert tr.op_group("dgrad", ["cudaGraphLaunch"], by_name) == \
        "deconv backward"
    assert tr.op_group("only_replayed", ["cudaGraphLaunch"], by_name) == \
        "graph replay"
    assert tr.op_group("dgrad", ["aten::conv_transpose2d"], by_name) == \
        "deconv forward"


def test_find_trace_raises_when_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        tr.find_trace(str(tmp_path))


@pytest.fixture(scope="module")
def hooked_runs(tmp_path_factory):
    """One tiny cifar10 wali-gp run without the hook and one with it
    tracing iterations 1-2 of 4."""
    base = tmp_path_factory.mktemp("hook")
    cfg = gan_inference_defaults("cifar10", "wali-gp", dim=8, batch_size=4)
    data = np.random.RandomState(0).randint(
        0, 256, (32, 3072)).astype(np.uint8)
    params = []
    mp = pytest.MonkeyPatch()
    try:
        for hook in (False, True):
            if hook:
                mp.setenv("GGAN_PROFILE", str(base / "prof"))
                mp.setenv("GGAN_PROFILE_START", "1")
                mp.setenv("GGAN_PROFILE_STEPS", "2")
            t = Trainer(GanInferenceModel(cfg), data, str(base / f"r{hook}"),
                        device="cpu", checkpoint_every=0)
            t.train(4)
            params.append(t.state.params)
    finally:
        mp.undo()
    return base, params


def test_profile_hook_writes_its_window_and_changes_no_value(hooked_runs):
    base, (plain, hooked) = hooked_runs
    files = os.listdir(base / "prof")
    assert len(files) == 1 and files[0].startswith("ggan.1-2.") \
        and files[0].endswith(".trace.json.gz")
    assert sorted(plain) == sorted(hooked)
    for name in plain:
        assert torch.equal(plain[name], hooked[name]), name
    # the trace holds the two iterations: 2 x (one G update + 5 D updates)
    # of the custom K1 Function's forward
    evs, _, _ = tr.load_events(tr.find_trace(str(base / "prof")))
    fwd = [e for e in evs if e.get("name") == "FusedConv2dBiasAct"]
    assert len(fwd) == 2 * (9 + 12 * 5)


def test_cli_json_line_on_the_hook_trace(hooked_runs, capsys):
    base, _ = hooked_runs
    assert tr.main([str(base / "prof"), "--iters", "2", "--top", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "trace_attribution"
    assert rec["lanes"] == "host" and rec["device_kind"] == "cpu"
    assert rec["busy_ms"] > 0
    assert rec["busy_ms_per_iter"] == pytest.approx(rec["busy_ms"] / 2,
                                                    abs=1e-3)
    assert abs(sum(rec["by_op"].values()) - 1.0) < 1e-3
    assert rec["by_op"]["conv gradients (cuDNN)"] > 0
    assert len(rec["top_ops"]) == 3
