"""The port's chunked resident loop (``graphical_gan_tpu_torch/train/
trainer.py``) on the CPU, where JAX's keys would depend on the chunking
and the port's do not: ``chunk_size`` None, 1 and 3 give the same
parameters, optimizer state, step, costs and checkpoint arrays, bit for
bit, over 12 iterations with a hook and checkpoints inside windows (the
preemption agreement made once per dispatch); a resume at a chunk
boundary (JAX ``tests/test_trainer.py: test_trainer_resident_resume``); a
preemption requested inside a dispatch stops at its end (JAX
``tests/test_preemption.py``, chunk 4); rollbacks inside a window (JAX
``tests/test_divergence_guard.py``, chunk 4), the reported iteration the
window's first non-finite one; SSGAN's device sampler at chunk 2 (JAX
``tests/test_ondevice_moving_mnist.py``); dp on 2 gloo ranks at chunk 2;
the three CLIs' ``--chunk-size``; and the new flags of the two bench
tools; the ``GGAN_PROFILE`` window aligned to dispatches. mnist ali at
dim 8, B 8 (``_torch_trainer.make_trainer``).
"""

import os

import numpy as np
import pytest
import torch

import _torch_dist
from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.data import moving_mnist
from graphical_gan_tpu_torch.tools import (
    bench_conv_kernel, bench_phase_deconv, trace_report)
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

# windows of a 12-iteration run checkpointing every 8 with a hook at 6:
# 0-4 alone (the early flushes), 5, 6-7, 8-11
ITERS = 12
WINDOWS = {None: [1, 1, 1, 1, 1, 1, 2, 4],
           1: [1] * ITERS,
           3: [1, 1, 1, 1, 1, 1, 2, 3, 1]}


def _spy(tr):
    """Record the trainer's dispatch sizes and its rank agreements."""
    seen = {"n": [], "agreements": 0}
    dispatch, agree = tr.dispatch, tr._any_rank

    def counted_dispatch(start, n, pend):
        seen["n"].append(n)
        return dispatch(start, n, pend)

    def counted_agree(flag):
        seen["agreements"] += 1
        return agree(flag)

    tr.dispatch, tr._any_rank = counted_dispatch, counted_agree
    return seen


def _arrays(tr, outf=None):
    """Every array of the state and of each checkpoint in ``outf``, as
    numpy."""
    out = {f"state/{k}": v.numpy() for k, v in
           ckpt_lib.state_leaves(tr.state).items()}
    for it, path in ckpt_lib.list_checkpoints(str(outf)) if outf else ():
        flat, extra = ckpt_lib.load_raw(path)
        out.update({f"ckpt_{it}/{k}": v for k, v in flat.items()})
        out[f"ckpt_{it}/extra"] = np.array(sorted(extra.items()), dtype=str)
    return out


def _same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def chunk_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("chunks")
    out = {}
    for chunk in WINDOWS:
        hooks = []
        outf = base / str(chunk)
        tr = make_trainer(outf, resident=True, checkpoint_every=8,
                          checkpoints_to_keep=0, chunk_size=chunk,
                          eval_hooks={6: lambda t, i: hooks.append(i)})
        seen = _spy(tr)
        last = tr.train(iters=ITERS, resume=False)
        out[chunk] = dict(tr=tr, seen=seen, hooks=hooks, last=last,
                          arrays=_arrays(tr, outf),
                          costs=tr.logger.history("train disc cost"))
    return out


@pytest.mark.parametrize("chunk", [None, 3])
def test_chunk_sizes_give_the_same_bits(chunk_runs, chunk):
    ref, got = chunk_runs[1], chunk_runs[chunk]
    assert got["seen"]["n"] == WINDOWS[chunk]
    assert got["tr"].state.step == ITERS
    assert got["hooks"] == ref["hooks"] == [5, 11]
    assert sorted(k.split("/")[0] for k in got["arrays"]
                  if k.endswith("extra")) == ["ckpt_11", "ckpt_7"]
    _same_bits(got["arrays"], ref["arrays"])
    assert got["costs"] == ref["costs"] and len(got["costs"]) == ITERS
    assert got["last"] == ref["last"]


@pytest.mark.parametrize("chunk", list(WINDOWS))
def test_preemption_is_agreed_once_per_dispatch(chunk_runs, chunk):
    seen = chunk_runs[chunk]["seen"]
    assert seen["agreements"] == len(seen["n"])


def test_resume_at_a_chunk_boundary(tmp_path):
    """A run to 8 (its last window 5-7 in one dispatch) resumed to 14
    equals a run to 14, where 8 is a dispatch boundary inside the window
    5-9."""
    kw = dict(resident=True, checkpoint_every=5, chunk_size=3,
              checkpoints_to_keep=0)
    straight = make_trainer(tmp_path / "a", **kw)
    seen = _spy(straight)
    straight.train(iters=14, resume=False)
    assert seen["n"] == [1, 1, 1, 1, 1, 3, 2, 3, 1]
    first = make_trainer(tmp_path / "b", **kw)
    first.train(iters=8, resume=False)
    resumed = make_trainer(tmp_path / "b", **kw)
    resumed.train(iters=14)
    assert resumed._start_iter == 8 and resumed.state.step == 14
    a, b = _arrays(straight, tmp_path / "a"), _arrays(resumed, tmp_path / "b")
    _same_bits({k: v for k, v in a.items() if not k.startswith("ckpt_7")},
               {k: v for k, v in b.items() if not k.startswith("ckpt_7")})


def test_preemption_inside_a_dispatch_stops_at_its_end(tmp_path):
    kw = dict(resident=True, checkpoint_every=100, chunk_size=4)
    tr = make_trainer(tmp_path / "cut", **kw)
    step, calls = tr.step_fn, []

    def step_preempting(state, raw, do_gen, generator):
        calls.append(1)
        if len(calls) == 7:               # iteration 6, in dispatch 5-8
            tr.request_preempt()
        return step(state, raw, do_gen, generator)

    tr.step_fn = step_preempting
    metrics = tr.train(iters=50, resume=False)
    assert tr.preempted and tr.state.step == 9
    assert np.isfinite(metrics["disc_cost"])
    assert [it for it, _ in ckpt_lib.list_checkpoints(str(tmp_path / "cut"))
            ] == [8]
    with open(os.path.join(str(tmp_path / "cut"), "logfile.txt")) as f:
        log = f.read()
    assert "preempted: checkpoint saved at iteration 8" in log
    assert sorted(tr.logger.history("train disc cost")) == list(range(9))
    resumed = make_trainer(tmp_path / "cut", **kw)
    resumed.train(iters=12)
    straight = make_trainer(tmp_path / "straight", **kw)
    straight.train(iters=12, resume=False)
    assert resumed._start_iter == 9
    _same_bits(_arrays(resumed), _arrays(straight))


def test_profile_window_is_dispatch_aligned(tmp_path, monkeypatch):
    """GGAN_PROFILE from iteration 3 for 5: the trace opens at the dispatch
    of 3 and closes after 5-8, the one that reaches 8; its name says
    so."""
    monkeypatch.setenv("GGAN_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("GGAN_PROFILE_START", "3")
    monkeypatch.setenv("GGAN_PROFILE_STEPS", "5")
    tr = make_trainer(tmp_path / "run", resident=True, checkpoint_every=0,
                      rows=16)
    tr.train(iters=9, resume=False)
    (name,) = os.listdir(tmp_path / "prof")
    assert name.startswith("ggan.3-8.")
    assert trace_report.traced_iterations(str(tmp_path / "prof")) == 6
    other = tmp_path / "other.trace.json.gz"    # not the trainer's trace
    other.write_bytes(b"")
    assert trace_report.traced_iterations(str(other)) is None


def test_rollback_inside_a_dispatch(tmp_path):
    """A cost poisoned at iteration 6, the first of the dispatch 6-7:
    restored from ckpt_5, the retry runs 6-7 on salt 1."""
    tr = make_trainer(tmp_path, resident=True, checkpoint_every=3,
                      max_rollbacks=2, chunk_size=4)
    seen = _spy(tr)
    step, calls = tr.step_fn, []

    def step_poisoning(state, raw, do_gen, generator):
        state, m = step(state, raw, do_gen, generator)
        calls.append(1)
        if len(calls) == 7:
            m = dict(m, disc_cost=m["disc_cost"] * float("nan"))
        return state, m

    tr.step_fn = step_poisoning
    metrics = tr.train(iters=8, resume=False)
    assert np.isfinite(metrics["disc_cost"])
    assert tr._rollbacks == 1 and tr._salt == 1 and tr.state.step == 8
    assert seen["n"] == [1, 1, 1, 1, 1, 1, 2, 2]
    with open(os.path.join(str(tmp_path), "logfile.txt")) as f:
        assert "non-finite training cost at iteration 6" in f.read()


@pytest.fixture(scope="module")
def fault_runs(tmp_path_factory):
    """GGAN_FAULT_NAN_AT=7 inside the window 6-8, at chunk 4 and 1."""
    base = tmp_path_factory.mktemp("faults")
    mp = pytest.MonkeyPatch()
    mp.setenv("GGAN_FAULT_NAN_AT", "7")
    out = {}
    try:
        for chunk in (4, 1):
            tr = make_trainer(base / str(chunk), resident=True,
                              checkpoint_every=3, max_rollbacks=2,
                              chunk_size=chunk)
            seen = _spy(tr)
            tr.train(iters=9, resume=False)
            with open(os.path.join(str(base / str(chunk)),
                                   "logfile.txt")) as f:
                out[chunk] = (tr, seen, f.read())
    finally:
        mp.undo()
    return base, out


def test_fault_drill_reports_the_window_s_first_bad_iteration(fault_runs):
    _, runs = fault_runs
    tr, seen, log = runs[4]
    assert tr._fault_fired and tr._rollbacks == 1 and tr._salt == 1
    assert tr.state.step == 9
    assert "non-finite training cost at iteration 7; rollback 1/2" in log
    # 6-8 is one dispatch, run twice: before and after the rollback
    assert seen["n"] == [1, 1, 1, 1, 1, 1, 3, 3]


def test_fault_drill_same_bits_at_chunk_1(fault_runs):
    base, runs = fault_runs
    assert "iteration 7; rollback 1/2" in runs[1][2]
    _same_bits(_arrays(runs[4][0], base / "4"),
               _arrays(runs[1][0], base / "1"))


def test_ssgan_device_sampler_at_chunk_2(tmp_path, monkeypatch):
    from graphical_gan_tpu_torch.runs import ssgan
    rng = np.random.RandomState(0)
    pools = ((rng.rand(24, 28, 28).astype(np.float32),
              rng.randint(0, 10, 24)),
             (rng.rand(12, 28, 28).astype(np.float32),
              rng.randint(0, 10, 12)))
    monkeypatch.setattr(moving_mnist, "_mnist_pool",
                        lambda cla, data_dir=None: pools)
    runs = {}
    for chunk in (2, 1):
        trainer, last = ssgan.run(
            "moving_mnist", "local_ep", iters=8,
            run_dir=str(tmp_path / str(chunk)), seed=0, eval_every=3,
            checkpoint_every=3, data_pipeline="device", chunk_size=chunk,
            dim=8, dim_op=16, batch_size=4, seq_len=4, device="cpu")
        assert all(np.isfinite(v) for v in last.values())
        assert trainer.chunk_size == chunk and trainer.state.step == 8
        runs[chunk] = _arrays(trainer, tmp_path / str(chunk))
    _same_bits(runs[2], runs[1])


def test_dp_two_ranks_chunk_2(tmp_path):
    runs = [{"outf": str(tmp_path / str(c)), "shape": (2,),
             "axes": ("data",), "parallel": "dp", "backend": "npz",
             "every": 100, "iters": 9, "model": {"chunk_size": c}}
            for c in (2, 1)]
    ranks = _torch_dist.start("trainer_worker", 2, {"runs": runs},
                              timeout=240).join()
    for rank in ranks:
        chunked, single = rank
        assert chunked["last"] == single["last"]
        _same_bits(chunked["full"], single["full"])
        _same_bits(chunked["full"], ranks[0][0]["full"])


class _Built(Exception):
    pass


@pytest.mark.parametrize("module, argv", [
    ("gan_inference", ["--dataset", "mnist", "--dim", "8"]),
    ("gmgan", ["--dataset", "mnist", "--dim", "8", "--n-coms", "3"]),
    ("ssgan", ["--data-pipeline", "device", "--dim", "4", "--seq-len",
               "3"])])
def test_clis_forward_chunk_size(module, argv, monkeypatch, tmp_path):
    """``--chunk-size`` reaches ``run()`` and the Trainer it builds."""
    import importlib
    mod = importlib.import_module(f"graphical_gan_tpu_torch.runs.{module}")
    rng = np.random.RandomState(0)
    pools = ((rng.rand(24, 28, 28).astype(np.float32),
              rng.randint(0, 10, 24)),) * 2
    monkeypatch.setattr(moving_mnist, "_mnist_pool",
                        lambda cla, data_dir=None: pools)
    got = {}

    def trainer(*args, **kw):
        got.update(kw)
        raise _Built

    monkeypatch.setattr(mod, "Trainer", trainer)
    with pytest.raises(_Built):
        mod.main(argv + ["--batch-size", "4", "--iters", "1", "--device",
                         "cpu", "--chunk-size", "3", "--outdir",
                         str(tmp_path)])
    assert got["chunk_size"] == 3


def test_bench_conv_kernel_flags_on_the_cpu(capsys):
    (rec,) = bench_conv_kernel.main(["--device", "cpu", "--reps", "2",
                                     "--rounds", "1", "--n-inputs", "3"])
    assert rec["shape"] == "toy" and rec["reps"] == 2
    assert all(rec[f"{a}_us"] > 0 for a in bench_conv_kernel.ARMS)
    # the sets a timer rotates over: 3 inputs, one filter and bias
    seen = []
    bench_conv_kernel.run(bench_conv_kernel.TOY_SHAPES, "float32", "cpu",
                          timer=lambda fn, sets: seen.append(sets) or 1.0,
                          n_inputs=3)
    for sets in seen:
        assert len(sets) == 3
        assert not torch.equal(sets[0][0], sets[1][0])
        assert all(s[1] is sets[0][1] or torch.equal(s[1], sets[0][1])
                   for s in sets)
    assert bench_conv_kernel.auto_reps(2e9) == 500
    assert bench_conv_kernel.auto_reps(1e6) == 1000
    assert bench_conv_kernel.auto_reps(1e12) == 20


def test_bench_phase_deconv_k_on_the_cpu():
    recs = bench_phase_deconv.main(["--device", "cpu", "--reps", "1",
                                    "--rounds", "1", "--k", "3",
                                    "--dtype", "float32"])
    assert [r["k"] for r in recs] == [3, 3]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 4, 8), generator=gen)
    w = torch.randn((3, 3, 3, 8), generator=gen)
    bias = torch.randn((3,), generator=gen)
    outs = {}
    for arm, (fn, filt) in bench_phase_deconv._arms(x, w, bias).items():
        y = fn(x, filt)
        if arm == "library":
            y = y.reshape(2, 4, 4, 2, 2, 3).permute(0, 1, 3, 2, 4, 5
                                                    ).reshape(2, 8, 8, 3)
        outs[arm] = y.numpy()
    for arm in ("phase", "library"):
        np.testing.assert_allclose(outs[arm], outs["cudnn"], rtol=2e-5,
                                   atol=2e-5)
    ms3, _ = bench_phase_deconv.k1_bound(64, 4, 256, 128, "float32", 3)
    ms5, _ = bench_phase_deconv.k1_bound(64, 4, 256, 128, "float32")
    assert ms3 < ms5
