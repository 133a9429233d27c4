"""Pipeline parallelism through the port's Trainer and CLI on 2 gloo
ranks on the CPU (``train/trainer.py``'s ``parallel="pp"``), mnist ali at
dim 8, B 8, 4 microbatches: a run resumed from its npz checkpoint equals
the uninterrupted run bit for bit, and so does one resumed from its
sharded ``.orbax`` directory (each rank writes its packed rows); a
one-device npz checkpoint resumes under pp (the standard state packed);
the pp checkpoint resumes unsharded with the pp run's parameters; the
family-1 CLI trains ``--parallel pp`` (mnist wali-gp).
"""

import os

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint, checkpoint_orbax


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import _torch_dist
    root = tmp_path_factory.mktemp("pp")
    make_trainer(root / "std", resident=True, checkpoint_every=2,
                 render_curves=False).train(iters=2)
    pp = dict(shape=(2,), axes=("stage",), parallel="pp", every=1)
    runs = [dict(pp, outf=str(root / "ref"), backend="npz", iters=3),
            dict(pp, outf=str(root / "run"), backend="npz", iters=2),
            dict(pp, outf=str(root / "run"), backend="npz", iters=3),
            dict(pp, outf=str(root / "orbax"), backend="orbax", iters=2),
            dict(pp, outf=str(root / "orbax"), backend="orbax", iters=3),
            dict(pp, outf=str(root / "std"), backend="npz", iters=3),
            {"cli": {"module": "graphical_gan_tpu_torch.runs.gan_inference",
                     "argv": ["--dataset", "mnist", "--mode", "wali-gp",
                              "--parallel", "pp", "--iters", "2", "--dim",
                              "8", "--batch-size", "8", "--device", "cpu",
                              "--outdir", str(root / "cli")]}}]
    res = _torch_dist.start("trainer_worker", 2, {"runs": runs},
                            timeout=240).join()
    return root, res


@pytest.mark.parametrize("run", [2, 4], ids=["npz", "orbax"])
def test_pp_resume_equals_uninterrupted(ranks, run):
    _, res = ranks
    for rank in res:
        assert rank[run]["start"] == 2
        assert rank[run]["last"] == rank[0]["last"]
        for key, want in rank[0]["full"].items():
            assert np.array_equal(rank[run]["full"][key], want), key


def test_pp_orbax_ranks_write_their_rows(ranks):
    root, _ = ranks
    path = root / "orbax" / "ckpt_1.orbax"
    keys = set(checkpoint_orbax._metadata(str(path)).state_dict_metadata)
    for field in ("packed", "m", "v"):
        assert {f"k:{field}@0:0/2", f"k:{field}@0:1/2"} <= keys
    assert sum(f.endswith(".distcp") for f in os.listdir(path)) == 2


def test_one_device_checkpoint_resumes_under_pp(ranks):
    _, res = ranks
    for rank in res:
        assert rank[5]["start"] == 2
        # the one-device run counted G 1, D 2 (k = 1); one more iteration
        assert list(rank[5]["full"]["t"]) == [2, 3]
        assert np.isfinite(rank[5]["last"]["disc_cost"])


@pytest.mark.parametrize("run", ["run", "orbax"])
def test_pp_checkpoint_resumes_unsharded(ranks, run):
    root, res = ranks
    one = make_trainer(root / run, resident=True, checkpoint_every=0,
                       render_curves=False)
    assert one.try_resume() and one._start_iter == 3
    for n, want in res[0][2]["params"].items():
        assert np.array_equal(one.state.params[n].numpy(), want), n
    stages_t = res[0][2]["full"]["t"]
    assert int(one.state.gen_opt["t"]) == stages_t[0]
    assert int(one.state.disc_opt["t"]) == stages_t[1]


def test_cli_trains_pp(ranks):
    root, res = ranks
    assert all(r[6]["ok"] for r in res)
    (run_dir,) = os.listdir(root / "cli")
    files = {os.path.basename(f) for f in res[0][6]["files"]}
    assert {"ckpt_1.npz", "logfile.txt", "config.json"} <= files
    flat, _ = checkpoint.load_raw(str(root / "cli" / run_dir / "ckpt_1.npz"))
    assert flat["k:packed"].shape[0] == 2
    with open(root / "cli" / run_dir / "logfile.txt") as f:
        log = f.read()
    assert "iter 1" in log and "train disc cost" in log
