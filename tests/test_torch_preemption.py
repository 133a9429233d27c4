"""Preemption of the port's trainer (JAX ``tests/test_preemption.py``):
``request_preempt`` (SIGTERM through ``install_preempt_handlers``) stops
the loop after the iteration in flight, which is checkpointed, and
``train()`` returns; ``--run-dir`` resumes it. On the CPU at dim 8; the
SIGTERM case also end to end through the CLI in a subprocess, whose
resumed run equals an uninterrupted one bit for bit.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from _torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "graphical_gan_tpu_torch.runs.gan_inference",
       "--dataset", "cifar10", "--mode", "wali-gp", "--dim", "8",
       "--batch-size", "4", "--device", "cpu"]


def test_preempt_host_loop_saves_and_resumes(tmp_path):
    tr = make_trainer(tmp_path, checkpoint_every=100)
    tr.eval_hooks = {3: lambda t, i: t.request_preempt()}
    metrics = tr.train(iters=10, resume=False)
    assert tr.preempted
    assert tr.state.step == 3                 # stopped after iteration 2
    assert np.isfinite(metrics["disc_cost"])
    assert os.path.isfile(os.path.join(str(tmp_path), "ckpt_2.npz"))
    with open(os.path.join(str(tmp_path), "logfile.txt")) as f:
        log = f.read()
    assert "preempted: checkpoint saved at iteration 2" in log
    # the pending device costs were drained into the log before stopping
    assert "iter 2\t" in log

    tr2 = make_trainer(tmp_path, checkpoint_every=100)
    metrics = tr2.train(iters=10)
    assert tr2._start_iter == 3
    assert not tr2.preempted
    assert tr2.state.step == 10
    assert np.isfinite(metrics["disc_cost"])


def test_preempt_resident_loop_stops_at_dispatch_boundary(tmp_path):
    tr = make_trainer(tmp_path, resident=True, checkpoint_every=100)
    tr.request_preempt()                      # pending before train()
    metrics = tr.train(iters=50, resume=False)
    assert tr.preempted
    # one iteration per dispatch: the request is honored after iteration 0
    assert tr.state.step == 1
    assert os.path.isfile(os.path.join(str(tmp_path), "ckpt_0.npz"))
    assert np.isfinite(metrics["disc_cost"])

    tr2 = make_trainer(tmp_path, resident=True, checkpoint_every=100)
    tr2.train(iters=8)
    assert tr2._start_iter == 1
    assert tr2.state.step == 8


def test_preempt_sigterm_end_to_end(tmp_path):
    """A real SIGTERM lands in the installed handler, in process and
    through the CLI in a subprocess: exit 0, and the resumed run's final
    state equals an uninterrupted run's bit for bit."""
    tr = make_trainer(tmp_path / "in", checkpoint_every=100)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preempt_handlers()
        tr.eval_hooks = {2: lambda t, i: os.kill(os.getpid(),
                                                 signal.SIGTERM)}
        tr.train(iters=10, resume=False)
        assert tr.preempted
        assert tr.state.step == 2
        assert os.path.isfile(str(tmp_path / "in" / "ckpt_1.npz"))
    finally:
        signal.signal(signal.SIGTERM, prev)

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               PYTHONUNBUFFERED="1")
    # dispatches of 4 iterations: at the default chunk size iterations 5-29
    # are one dispatch, which a SIGTERM cannot cut before its end
    iters = ["--iters", "30", "--chunk-size", "4"]
    straight = tmp_path / "straight"
    # the uninterrupted run goes on beside the cut one and its resume
    ref = subprocess.Popen(CLI + iters + ["--run-dir", str(straight)],
                           env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
    run = tmp_path / "cut"
    proc = subprocess.Popen(CLI + iters + ["--run-dir", str(run)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:  # iterations 0-4 are logged; then wait a bit
        lines.append(line)
        if line.startswith("iter 4\t"):
            time.sleep(0.5)
            proc.send_signal(signal.SIGTERM)
            break
    rest, _ = proc.communicate(timeout=300)
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "preempted: checkpoint saved at iteration" in out
    stopped = ckpt_lib.list_checkpoints(str(run))[-1][0]
    assert 4 <= stopped < 29
    subprocess.run(CLI + iters + ["--run-dir", str(run)], env=env, cwd=ROOT,
                   check=True, capture_output=True, timeout=300)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err
    a, _ = ckpt_lib.load_raw(str(straight / "ckpt_29.npz"))
    b, _ = ckpt_lib.load_raw(str(run / "ckpt_29.npz"))
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_preempt_handler_install_skipped_off_main_thread(tmp_path):
    tr = make_trainer(tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=tr.install_preempt_handlers)
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) is prev  # no-op, no crash
    assert torch.get_num_threads() >= 1
