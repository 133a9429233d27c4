"""The divergence guard of the port's trainer (JAX
``tests/test_divergence_guard.py``): with ``max_rollbacks > 0`` a
non-finite drained training cost restores the latest checkpoint (an anchor
``ckpt_-1`` where none exists) and retries on a new salt of the random
stream, never one that diverged before, also across restarts; the refusals
JAX makes; ``GGAN_FAULT_NAN_AT``; a preemption after a NaN rolls back. The
JAX salt test becomes the port's seeds: salt 0 is the stream of an
unsalted run, and salted streams differ from it and from the eval streams.
On the CPU at dim 8, B 8. (JAX's mesh case waits on the port's
parallelism.)
"""

import glob
import os

import numpy as np
import pytest
import torch

from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.trainer import DivergenceError
from _torch_threads import one_thread  # noqa: F401


# -- the salted stream ---------------------------------------------------------

def test_salt_zero_is_the_unsalted_stream(tmp_path):
    tr = make_trainer(tmp_path)
    seeds = {it: tr.iteration_seed(it) for it in range(3)}
    assert seeds == {it: (tr.seed << 32) + it for it in range(3)}
    tr.seed = 5
    evals = {(s, it): tr.eval_generator(s, it).initial_seed()
             for s in range(1, 6) for it in range(4)}
    plain = {tr.iteration_seed(it) for it in range(4)}
    salted = set()
    for salt in (1, 2, 3):
        tr._salt = salt
        salted |= {tr.iteration_seed(it) for it in range(4)}
    assert len(salted) == 12
    assert not salted & plain and not salted & set(evals.values())
    assert not plain & set(evals.values())
    # a CPU generator reads the low 32 bits only: apart there too
    low = {s & 0xFFFFFFFF for s in salted}
    assert len(low) == 12
    assert not low & {s & 0xFFFFFFFF for s in plain | set(evals.values())}
    tr._salt = 0                              # and back
    assert {tr.iteration_seed(it) for it in range(4)} == plain
    # a generator seeded for a salted iteration draws another stream
    a = torch.Generator().manual_seed(tr.iteration_seed(0))
    tr._salt = 1
    b = torch.Generator().manual_seed(tr.iteration_seed(0))
    assert not torch.equal(torch.rand(4, generator=a),
                           torch.rand(4, generator=b))


def _inject_nan_step(tr, fire_on_call):
    """Wrap ``tr.step_fn`` to poison disc_cost once, on the Nth call."""
    orig = tr.step_fn
    seen = {"n": 0, "fired": False}

    def step(state, raw, do_gen, generator):
        state, m = orig(state, raw, do_gen, generator)
        seen["n"] += 1
        if seen["n"] == fire_on_call and not seen["fired"]:
            seen["fired"] = True
            m = dict(m, disc_cost=m["disc_cost"] * float("nan"))
        return state, m

    tr.step_fn = step
    return seen


def _log(tmp_path):
    with open(os.path.join(str(tmp_path), "logfile.txt")) as f:
        return f.read()


# -- host-fed path -------------------------------------------------------------

def test_guard_host_rollback_recovers(tmp_path):
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    _inject_nan_step(tr, fire_on_call=4)      # iteration 3
    metrics = tr.train(iters=7, resume=False)
    assert np.isfinite(metrics["disc_cost"])
    assert tr._rollbacks == 1
    assert tr._salt == 1
    # steps 0-2 before the rollback (ckpt_2 holds step 3), the retry 3-6
    assert tr.state.step == 7
    log = _log(tmp_path)
    assert "divergence guard" in log and "iteration 3" in log


def test_guard_salt_survives_checkpoint_resume(tmp_path):
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    _inject_nan_step(tr, fire_on_call=4)
    tr.train(iters=7, resume=False)
    tr2 = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    tr2.train(iters=8)                        # resumes from ckpt_6
    assert tr2._start_iter == 7
    assert tr2._salt == 1                     # the salted stream goes on
    _, extra = ckpt_lib.load_raw(os.path.join(str(tmp_path), "ckpt_7.npz"))
    assert extra["rng_salt"] == 1 and extra["rng_salt_high"] == 1


def test_guard_budget_exhausted_raises(tmp_path):
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=1)
    orig = tr.step_fn

    def always_nan(state, raw, do_gen, generator):
        state, m = orig(state, raw, do_gen, generator)
        return state, dict(m, disc_cost=m["disc_cost"] * float("nan"))

    tr.step_fn = always_nan
    with pytest.raises(DivergenceError, match="budget exhausted"):
        tr.train(iters=7, resume=False)
    assert tr._rollbacks == 2                 # 1 allowed + the fatal one


def test_guard_anchor_checkpoint_covers_early_nan(tmp_path):
    """A NaN before the first periodic checkpoint rolls back to the
    initial state's anchor, ckpt_-1."""
    tr = make_trainer(tmp_path, checkpoint_every=100, max_rollbacks=1)
    _inject_nan_step(tr, fire_on_call=1)      # iteration 0
    metrics = tr.train(iters=4, resume=False)
    assert np.isfinite(metrics["disc_cost"])
    assert os.path.isfile(os.path.join(str(tmp_path), "ckpt_-1.npz"))
    assert tr._rollbacks == 1
    assert tr.state.step == 4


def test_guard_disabled_by_default(tmp_path):
    """max_rollbacks=0: no anchor, no check; the NaN reaches the log."""
    tr = make_trainer(tmp_path, checkpoint_every=3)
    _inject_nan_step(tr, fire_on_call=2)
    tr.train(iters=4, resume=False)
    assert not os.path.isfile(os.path.join(str(tmp_path), "ckpt_-1.npz"))
    assert tr._rollbacks == 0
    log = _log(tmp_path)
    assert "divergence guard" not in log and "nan" in log


# -- resident path ---------------------------------------------------------------

def test_guard_resident_rollback_recovers(tmp_path):
    tr = make_trainer(tmp_path, resident=True, checkpoint_every=3,
                      max_rollbacks=2)
    _inject_nan_step(tr, fire_on_call=7)      # iteration 6
    metrics = tr.train(iters=8, resume=False)
    assert np.isfinite(metrics["disc_cost"])
    assert tr._rollbacks == 1
    assert tr._salt == 1
    # restored from ckpt_5 (step 6), the retry runs iterations 6-7
    assert tr.state.step == 8
    log = _log(tmp_path)
    assert "divergence guard" in log and "iteration 6" in log


# -- fault injection ---------------------------------------------------------------

def test_fault_injection_host_drill(tmp_path, monkeypatch):
    """GGAN_FAULT_NAN_AT poisons one observed cost: the guard detects it,
    rolls back, re-salts, and the retry completes (it fires once)."""
    monkeypatch.setenv("GGAN_FAULT_NAN_AT", "4")
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    metrics = tr.train(iters=8, resume=False)
    assert tr._fault_fired
    assert tr._rollbacks == 1
    assert tr._salt == 1
    assert np.isfinite(metrics["disc_cost"])
    assert tr.state.step == 8
    assert "iteration 4" in _log(tmp_path)


def test_fault_injection_resident_drill(tmp_path, monkeypatch):
    monkeypatch.setenv("GGAN_FAULT_NAN_AT", "6")
    tr = make_trainer(tmp_path, resident=True, checkpoint_every=3,
                      max_rollbacks=2)
    metrics = tr.train(iters=9, resume=False)
    assert tr._fault_fired
    assert tr._rollbacks == 1
    assert np.isfinite(metrics["disc_cost"])
    assert tr.state.step == 9


def test_fault_injection_inert_without_guard(tmp_path, monkeypatch):
    """Without max_rollbacks the drill poisons only the logged value."""
    monkeypatch.setenv("GGAN_FAULT_NAN_AT", "2")
    tr = make_trainer(tmp_path, checkpoint_every=3)
    metrics = tr.train(iters=5, resume=False)
    assert tr._fault_fired
    assert tr._rollbacks == 0
    assert np.isfinite(metrics["disc_cost"])
    assert tr.state.step == 5


def test_rollback_salt_is_monotonic_across_restart(tmp_path):
    """After a rollback to salt 1 and a resume, a second divergence takes
    salt 2, never the failed salt 1 again."""
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    _inject_nan_step(tr, fire_on_call=4)
    tr.train(iters=7, resume=False)
    assert tr._salt == 1

    tr2 = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    _inject_nan_step(tr2, fire_on_call=3)     # diverge again on restart
    tr2.train(iters=10)
    assert tr2._rollbacks == 1
    assert tr2._salt == 2                     # salt_high + 1
    assert tr2._salt_high == 2


def test_preempt_after_nan_rolls_back_instead_of_checkpointing(tmp_path):
    """A preemption after a NaN does not checkpoint the poisoned state:
    its drain runs the guard's check first."""
    tr = make_trainer(tmp_path, checkpoint_every=3, max_rollbacks=2)
    seen = _inject_nan_step(tr, fire_on_call=6)   # iteration 5: no drain
    orig = tr.step_fn

    def step(state, raw, do_gen, generator):
        out = orig(state, raw, do_gen, generator)
        if seen["fired"] and not tr._preempt.is_set():
            tr.request_preempt()              # preempt right after poison
        return out

    tr.step_fn = step
    metrics = tr.train(iters=12, resume=False)
    # the guard fired (rollback to ckpt_2), and the retry then honored the
    # pending preemption from the restored state
    assert tr._rollbacks == 1
    assert tr.preempted
    assert np.isfinite(metrics["disc_cost"])
    for p in glob.glob(os.path.join(str(tmp_path), "ckpt_*.npz")):
        flat, _ = ckpt_lib.load_raw(p)
        assert all(np.isfinite(a).all() for a in flat.values()
                   if np.issubdtype(a.dtype, np.floating)), p


def test_guard_refuses_fresh_run_over_stale_checkpoints(tmp_path):
    t1 = make_trainer(tmp_path, checkpoint_every=2)
    t1.train(iters=4, resume=False)           # leaves ckpt_1, ckpt_3
    t2 = make_trainer(tmp_path, checkpoint_every=2, max_rollbacks=1)
    with pytest.raises(ValueError, match="already holds checkpoints"):
        t2.train(iters=6, resume=False)
