"""The 4-stage pipeline (the conv-trunk cut) through the port's Trainer
and CLI on 4 gloo ranks on the CPU, cifar10 ali at dim 8, B 8, 4
microbatches: a run resumed from its npz checkpoint equals the
uninterrupted run bit for bit; a one-device checkpoint resumes under the
4 stages (the standard state packed into 4 rows); the 4-row checkpoint
resumes unsharded with the pp run's parameters and moments; the CLI's
``--parallel pp --mesh-shape 4`` trains the 4-stage cut.
"""

import os

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint

MODEL = {"dataset": "cifar10", "mode": "ali"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import _torch_dist
    root = tmp_path_factory.mktemp("pp4")
    make_trainer(root / "std", resident=True, checkpoint_every=2,
                 render_curves=False, **MODEL).train(iters=2)
    pp = dict(shape=(4,), axes=("stage",), parallel="pp", every=1,
              backend="npz", model=MODEL)
    runs = [dict(pp, outf=str(root / "ref"), iters=3),
            dict(pp, outf=str(root / "run"), iters=2),
            dict(pp, outf=str(root / "run"), iters=3),
            dict(pp, outf=str(root / "std"), iters=3),
            {"cli": {"module": "graphical_gan_tpu_torch.runs.gan_inference",
                     "argv": ["--dataset", "cifar10", "--mode", "ali",
                              "--parallel", "pp", "--mesh-shape", "4",
                              "--iters", "2", "--dim", "8", "--batch-size",
                              "8", "--device", "cpu",
                              "--outdir", str(root / "cli")]}}]
    res = _torch_dist.start("trainer_worker", 4, {"runs": runs},
                            timeout=240).join()
    return root, res


def test_pp4_resume_equals_uninterrupted(ranks):
    _, res = ranks
    for rank in res:
        assert rank[2]["start"] == 2
        assert rank[2]["last"] == rank[0]["last"]
        for key, want in rank[0]["full"].items():
            assert np.array_equal(rank[2]["full"][key], want), key


def test_one_device_checkpoint_resumes_under_pp4(ranks):
    _, res = ranks
    for rank in res:
        assert rank[3]["start"] == 2
        # G: 1 + 1 on stages 0-1, D: 2 + 1 on stages 2-3 (k = 1)
        assert list(rank[3]["full"]["t"]) == [2, 2, 3, 3]
        assert np.isfinite(rank[3]["last"]["disc_cost"])


def test_pp4_checkpoint_resumes_unsharded(ranks):
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    root, res = ranks
    one = make_trainer(root / "run", resident=True, checkpoint_every=0,
                       render_curves=False, **MODEL)
    assert one.try_resume() and one._start_iter == 3
    full = res[0][2]["full"]
    stages = pp.normalized_stages(one.model, 4)
    for r, tmpl in enumerate(stages.templates):
        opt = one.state.gen_opt if r in (0, 1) else one.state.disc_opt
        for n, shape, off, size in tmpl.entries:
            assert np.array_equal(one.state.params[n].numpy().reshape(-1),
                                  full["packed"][r, off:off + size]), n
            for slot in ("m", "v"):
                assert np.array_equal(opt[slot][n].numpy().reshape(-1),
                                      full[slot][r, off:off + size])


def test_cli_trains_pp4(ranks):
    root, res = ranks
    assert all(r[4]["ok"] for r in res)
    (run_dir,) = os.listdir(root / "cli")
    flat, _ = checkpoint.load_raw(str(root / "cli" / run_dir / "ckpt_1.npz"))
    assert flat["k:packed"].shape[0] == 4
    assert list(flat["k:t"]) == [1, 1, 2, 2]
