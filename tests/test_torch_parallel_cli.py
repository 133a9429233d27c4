"""The family-1 training CLI on 2 gloo ranks on the CPU under dp,
as ``torchrun --nproc-per-node 2 -m graphical_gan_tpu_torch.runs.
gan_inference --device cpu --n-devices 2 ...`` starts it, a few iterations
at a narrow width (``test_torch_parallel_cli_tp.py`` runs tp,
``test_torch_parallel_cli_families.py`` the other CLIs and composed).
Rank 0 alone writes the run directory.
"""

import glob
import os

import numpy as np
import pytest

import _torch_dist
from _torch_threads import one_thread  # noqa: F401

GAN = "graphical_gan_tpu_torch.runs.gan_inference"
TINY = ["--iters", "3", "--dim", "8", "--batch-size", "4", "--device",
        "cpu", "--checkpoint-every", "0"]
RUNS = {
    "dp": (2, GAN, ["--dataset", "mnist", "--mode", "ali", "--n-devices",
                    "2"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = {}
    for name, (world, module, argv) in RUNS.items():
        out = str(tmp_path_factory.mktemp(name))
        args = (argv if name == "sp" else TINY + argv) + ["--outdir", out]
        jobs[name] = (out, _torch_dist.start(
            "cli_worker", world, {"module": module, "argv": args},
            timeout=240))
    return {name: (out, job.join()) for name, (out, job) in jobs.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_trains_on_ranks(runs, name):
    out, ranks = runs[name]
    assert len(ranks) == RUNS[name][0]
    run_dirs = glob.glob(os.path.join(out, "*"))
    assert len(run_dirs) == 1, run_dirs  # one directory, rank 0's
    files = set(os.listdir(run_dirs[0]))
    assert {"config.json", "logfile.txt", "ckpt_2.npz"} <= files
    with open(os.path.join(run_dirs[0], "logfile.txt")) as f:
        log = f.read()
    assert log.count("iter 2\t") == 1  # rank 0 alone logs


def test_rollback_under_async_checkpoints_restores_one_iteration(tmp_path):
    """2 dp ranks, async checkpoints every 2 iterations with rank 0's
    write slowed, a NaN at iteration 2 under the divergence guard: every
    rank waits for rank 0's write of ckpt_1 and restores it (resuming at
    2), and the replicas end bit-identical."""
    ranks = _torch_dist.start(
        "rollback_worker", 2, {"outf": str(tmp_path), "delay": 1.0,
                               "nan_at": 2, "every": 2, "iters": 4},
        timeout=120).join()
    # the start finds nothing to resume; the rollback resumes at 2
    assert [r["restores"] for r in ranks] == [[None, 2], [None, 2]]
    for key, v in ranks[0]["full"].items():
        assert np.array_equal(v, ranks[1]["full"][key]), key
    with open(os.path.join(str(tmp_path), "logfile.txt")) as f:
        assert f.read().count("divergence guard") == 1
