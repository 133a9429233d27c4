"""The sharded checkpoint backend (``graphical_gan_tpu_torch/train/
checkpoint_orbax.py``, ``Trainer(checkpoint_backend="orbax")``), JAX's
cases of ``tests/test_orbax_backend.py``: npz files and ``.orbax``
directories in one run directory, ``remove`` and ``load_raw`` on both,
a resumed run equal to an uninterrupted one bit for bit, keep-k garbage
collection; on 2 gloo ranks on the CPU a tp run whose ranks each write
their slices and resume sharded (equal to the uninterrupted tp run) and
a one-device directory resumed under tp (elastic); the pipeline's rows:
``test_torch_pipeline_trainer.py``. A directory JAX's orbax writes
(OCDBT) is refused with the npz route.
"""

import os

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint, checkpoint_orbax


def _state(x):
    from graphical_gan_tpu_torch.train.step import TrainState
    return TrainState(params={"a": x}, gen_opt={}, disc_opt={}, step=2)


def test_mixed_formats_in_one_dir(tmp_path):
    checkpoint.save_state(str(tmp_path / "ckpt_1.npz"), _state(torch.zeros(4)))
    checkpoint.save_state(str(tmp_path / "ckpt_2.orbax"),
                    _state(torch.arange(4.0)), extra={"iteration": 2})
    steps = [s for s, _ in checkpoint.list_checkpoints(str(tmp_path))]
    assert steps == [1, 2]
    latest = checkpoint.latest(str(tmp_path))
    assert latest.endswith("ckpt_2.orbax")
    st, extra = checkpoint.restore_state(latest, _state(torch.zeros(4)))
    assert extra["iteration"] == 2 and st.step == 2
    assert torch.equal(st.params["a"], torch.arange(4.0))
    assert checkpoint.leaf_shapes(latest)["n:params|k:a"] == (4,)


def test_remove_handles_both_formats(tmp_path):
    p1 = checkpoint.save_state(str(tmp_path / "ckpt_1.npz"),
                               _state(torch.ones(2)))
    p2 = checkpoint.save_state(str(tmp_path / "ckpt_2.orbax"),
                         _state(torch.ones(2)), extra={"iteration": 2})
    checkpoint.remove(p1)
    checkpoint.remove(p2)
    assert checkpoint.list_checkpoints(str(tmp_path)) == []
    assert not (tmp_path / "ckpt_2.orbax.extra.json").exists()


def test_load_raw_rejects_orbax(tmp_path):
    p = checkpoint.save_state(str(tmp_path / "ckpt_1.orbax"),
                              _state(torch.ones(2)))
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_raw(p)


def test_a_directory_without_its_sidecar_is_an_interrupted_save(tmp_path):
    p = checkpoint.save_state(str(tmp_path / "ckpt_3.orbax"),
                              _state(torch.ones(2)))
    os.unlink(checkpoint_orbax.extra_path(p))
    assert checkpoint.list_checkpoints(str(tmp_path)) == []


def test_jax_orbax_directory_is_refused_with_the_npz_route(tmp_path):
    d = tmp_path / "ckpt_5.orbax"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    (d / "manifest.ocdbt").write_bytes(b"\0")
    with pytest.raises(ValueError, match="npz"):
        checkpoint.restore_state(str(d), _state(torch.ones(2)))


def test_trainer_orbax_resume_matches_uninterrupted(tmp_path):
    ref = make_trainer(tmp_path / "ref", resident=True, checkpoint_every=2,
                       render_curves=False)
    ref.train(iters=6)
    kw = dict(resident=True, checkpoint_every=2, render_curves=False,
              checkpoint_backend="orbax")
    make_trainer(tmp_path / "run", **kw).train(iters=4)
    assert checkpoint.latest(str(tmp_path / "run")).endswith("ckpt_3.orbax")
    t2 = make_trainer(tmp_path / "run", **kw)
    t2.train(iters=6)
    assert t2._start_iter == 4
    for n, p in ref.state.params.items():
        assert torch.equal(p, t2.state.params[n]), n
    for field in ("gen_opt", "disc_opt"):
        for slot in ("m", "v"):
            for n, t in getattr(ref.state, field)[slot].items():
                assert torch.equal(t, getattr(t2.state, field)[slot][n])


def test_trainer_orbax_gc_keeps_k(tmp_path):
    t = make_trainer(tmp_path / "run", resident=True, checkpoint_every=1,
                     checkpoints_to_keep=2, render_curves=False,
                     checkpoint_backend="orbax")
    t.train(iters=5)
    steps = [s for s, _ in checkpoint.list_checkpoints(str(tmp_path / "run"))]
    assert steps == [3, 4]
    sidecars = {f.name for f in (tmp_path / "run").iterdir()
                if f.name.endswith(".extra.json")}
    assert sidecars == {"ckpt_3.orbax.extra.json", "ckpt_4.orbax.extra.json"}


def _keys(path):
    return set(checkpoint_orbax._metadata(str(path)).state_dict_metadata)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """On 2 gloo ranks: a tp run to 3 uninterrupted, one to 2 resumed to
    3; a one-device orbax directory resumed under tp (orbax
    throughout)."""
    import _torch_dist
    root = tmp_path_factory.mktemp("sharded")
    single = make_trainer(root / "elastic", resident=True,
                          checkpoint_every=2, render_curves=False,
                          checkpoint_backend="orbax")
    single.train(iters=3)
    tp = dict(shape=(1, 2), axes=("data", "model"), parallel="tp",
              backend="orbax", every=2)
    runs = [dict(tp, outf=str(root / "tp_ref"), iters=3),
            dict(tp, outf=str(root / "tp_run"), iters=2),
            dict(tp, outf=str(root / "tp_run"), iters=3),
            dict(tp, outf=str(root / "elastic"), iters=5)]
    res = _torch_dist.start("trainer_worker", 2, {"runs": runs},
                            timeout=240).join()
    return root, res


def test_tp_ranks_write_their_slices_and_resume_sharded(ranks):
    root, res = ranks
    path = root / "tp_run" / "ckpt_1.orbax"
    keys = _keys(path)
    sliced = {k for k in keys if "@" in k}
    assert sliced and any(k.endswith("@1:1/2") or k.endswith("@0:1/2")
                          for k in sliced)
    assert sum(f.endswith(".distcp") for f in os.listdir(path)) == 2
    for rank in res:
        assert rank[2]["start"] == 2
        for key, want in rank[0]["full"].items():
            assert np.array_equal(rank[2]["full"][key], want), key


def test_one_device_directory_resumes_under_tp(ranks):
    _, res = ranks
    for rank in res:
        assert rank[3]["start"] == 3
        assert np.isfinite(rank[3]["last"]["disc_cost"])
