"""The port's chunked resident loop (``graphical_gan_tpu_torch/train/
trainer.py``) against the JAX trainer's schedule: ``_next_event`` equal to
JAX's at every boundary of a few cadence sets, and the JAX test's
resident run (``tests/test_trainer.py: test_trainer_resident_mode``: mnist
ali, dim 8, B 8, 7 iterations, a checkpoint every 3, a hook every 2) at
``chunk_size`` 4 and None through both trainers: the same hook
iterations, checkpoint names, tick count, cost entries and (iteration,
metric names) log lines. JAX's scanned chunk is compiled once per length
at XLA's lowest level and shared by its trainers.
"""

import os
import types

import numpy as np
import pytest

from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.data.common import generator_factory as jax_factory
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu.train.trainer import Trainer as JaxTrainer
from graphical_gan_tpu_torch.train.trainer import Trainer
from _torch_gmgan import FAST
from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer

ITERS = 7
# JAX's scanned chunk, compiled once per length n
_COMPILED = {}


def _fast_chunks(tr):
    """Compile ``tr``'s scanned chunks with FAST, once per length for all
    trainers of this module (one config: the programs are the same)."""
    build = tr._chunk_fn

    def chunk_fn(n):
        jitted = build(n)

        def call(state, data, key):
            if n not in _COMPILED:
                _COMPILED[n] = jitted.lower(state, data, key).compile(FAST)
            return _COMPILED[n](state, data, key)
        return call

    tr._chunk_fn = chunk_fn


def _jax_trainer(outf, hooks, chunk_size):
    cfg = jax_cfg("mnist", "ali", dim=8, batch_size=8)
    rng = np.random.RandomState(0)
    x = rng.rand(64, 784).astype("float32")
    y = rng.randint(0, 10, size=64)
    tr = JaxTrainer(JaxM(cfg), jax_factory(8, x, y, seed=0),
                    jax_factory(8, x[:16], y[:16], seed=1), outf=outf,
                    checkpoint_every=3, eval_hooks={2: hooks.append_it},
                    resident_data=rng.rand(64, 784).astype("float32"),
                    chunk_size=chunk_size, render_curves=False)
    _fast_chunks(tr)
    return tr


class _Calls(list):
    def append_it(self, trainer, iteration):
        self.append(iteration)


def _log_lines(outf):
    """(iteration, metric names) of each ``iter N`` line."""
    with open(os.path.join(outf, "logfile.txt")) as f:
        return [(int(ln.split("\t")[0][5:]), ln.rstrip("\n").split("\t")[1::2])
                for ln in f if ln.startswith("iter ")]


def _ckpts(outf):
    return sorted(f for f in os.listdir(outf) if f.startswith("ckpt_"))


@pytest.mark.parametrize("chunk_size", [4, None])
def test_resident_schedule_is_jax(tmp_path, chunk_size):
    jax_hooks, port_hooks = _Calls(), _Calls()
    jt = _jax_trainer(str(tmp_path / "jax"), jax_hooks, chunk_size)
    jt.train(iters=ITERS, resume=False)
    pt = make_trainer(tmp_path / "port", resident=True, checkpoint_every=3,
                      eval_hooks={2: port_hooks.append_it},
                      chunk_size=chunk_size, render_curves=False)
    pt.train(iters=ITERS, resume=False)
    assert jax_hooks == port_hooks == [1, 3, 5]
    assert _ckpts(str(tmp_path / "jax")) == _ckpts(str(tmp_path / "port")) \
        == ["ckpt_2.npz", "ckpt_5.npz", "ckpt_6.npz"]
    for tr in (jt, pt):
        assert tr.logger.iteration == ITERS
        assert len(tr.logger.history("train disc cost")) == ITERS
        assert not tr.logger.pending
    assert pt.state.step == int(jt.state.step) == ITERS
    lines = _log_lines(str(tmp_path / "port"))
    assert lines == _log_lines(str(tmp_path / "jax"))
    # the flushes at iterations 0-4, then the last one after the run's
    # last tick
    assert [it for it, _ in lines] == [0, 1, 2, 3, 4, 7]


@pytest.mark.parametrize("checkpoint_every, hooks, iters", [
    (5000, (), 1000), (3, (2,), 20), (8, (6,), 12), (0, (7, 250), 600),
    (150, (40, 100), 333)])
def test_next_event_is_jax(checkpoint_every, hooks, iters):
    """Every boundary of a run, walked from 0 as the loop walks it."""
    port = Trainer.__new__(Trainer)
    port.checkpoint_every = checkpoint_every
    port.eval_hooks = {h: None for h in hooks}
    ref = types.SimpleNamespace(checkpoint_every=checkpoint_every,
                                eval_hooks=port.eval_hooks)
    done, walk = 0, []
    while done < iters:
        nxt = port._next_event(done, iters)
        assert nxt == JaxTrainer._next_event(ref, done, iters), done
        walk.append(nxt)
        done = nxt
    assert walk[:5] == [1, 2, 3, 4, 5] and walk[-1] == iters
