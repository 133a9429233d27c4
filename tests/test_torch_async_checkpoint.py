"""Async checkpoints of the port's trainer (JAX
``tests/test_async_checkpoint.py``): ``save()`` clones the state and an
ordered worker thread copies it to the host and writes the npz
(``train/checkpoint.py: AsyncWriter``). The files equal a synchronous
run's bit for bit, a run resumes from them, the writer keeps submission
order and re-raises a worker's exception once, and ``GGAN_ASYNC_CKPT=1``
turns it on. On the CPU at dim 8, B 8.
"""

import os

import numpy as np
import pytest
import torch

from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from _torch_threads import one_thread  # noqa: F401


def test_async_run_matches_sync_run(tmp_path):
    t_sync = make_trainer(tmp_path / "sync", resident=True,
                          checkpoint_every=3)
    t_sync.train(iters=7, resume=False)
    t_async = make_trainer(tmp_path / "async", resident=True,
                           checkpoint_every=3, async_checkpoint=True)
    t_async.train(iters=7, resume=False)

    # the snapshot does not perturb the run ...
    for n, p in t_sync.params.items():
        assert torch.equal(p, t_async.params[n]), n
    # ... and the files on disk are the same
    names = sorted(f for f in os.listdir(tmp_path / "sync")
                   if f.startswith("ckpt_"))
    assert names == ["ckpt_2.npz", "ckpt_5.npz", "ckpt_6.npz"]
    assert sorted(f for f in os.listdir(tmp_path / "async")
                  if f.startswith("ckpt_")) == names
    for f in names:
        fa, ea = ckpt_lib.load_raw(str(tmp_path / "async" / f))
        fs, es = ckpt_lib.load_raw(str(tmp_path / "sync" / f))
        assert ea == es
        assert set(fa) == set(fs)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fs[k], err_msg=f"{f}:{k}")


def test_async_checkpoint_resume_mid_run(tmp_path):
    t1 = make_trainer(tmp_path, checkpoint_every=2, async_checkpoint=True)
    t1.train(iters=5, resume=False)
    t2 = make_trainer(tmp_path, checkpoint_every=2, async_checkpoint=True)
    metrics = t2.train(iters=9)
    assert t2._start_iter == 5
    assert t2.state.step == 9
    assert np.isfinite(metrics["disc_cost"])


def test_async_writer_ordering_and_error_propagation(tmp_path):
    w = ckpt_lib.AsyncWriter()
    for i in range(3):
        w.submit(str(tmp_path / f"ckpt_{i}.npz"),
                 {"k:a": torch.full((4,), float(i))}, {"iteration": i})
    w.join()
    assert ckpt_lib.latest(str(tmp_path)).endswith("ckpt_2.npz")
    for i in range(3):
        flat, extra = ckpt_lib.load_raw(str(tmp_path / f"ckpt_{i}.npz"))
        assert extra["iteration"] == i
        np.testing.assert_array_equal(flat["k:a"], np.full(4, i))

    def boom():
        raise RuntimeError("after hook failed")

    w.submit(str(tmp_path / "ckpt_3.npz"), {"k:a": np.zeros(1)}, {},
             after=boom)
    with pytest.raises(RuntimeError, match="after hook failed"):
        w.join()
    w.join()  # raised once; the writer is usable again
    ckpt_lib.remove(str(tmp_path / "ckpt_3.npz"))
    ckpt_lib.remove(str(tmp_path / "ckpt_3.npz"))  # gone already: no error
    assert ckpt_lib.latest(str(tmp_path)).endswith("ckpt_2.npz")


def test_env_var_enables_async(tmp_path, monkeypatch):
    monkeypatch.setenv("GGAN_ASYNC_CKPT", "1")
    tr = make_trainer(tmp_path)
    assert tr._ckpt_writer is not None
    monkeypatch.delenv("GGAN_ASYNC_CKPT")
    tr = make_trainer(tmp_path)
    assert tr._ckpt_writer is None
