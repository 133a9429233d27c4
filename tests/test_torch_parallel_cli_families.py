"""The GMGAN and SSGAN training CLIs on 2 gloo ranks on the CPU, under ep
and sp, and the family-1 CLI under composed ``data=2,model=2`` on 4
ranks, as ``torchrun --nproc-per-node N -m graphical_gan_tpu_torch.runs.
<family> --device cpu --n-devices N --parallel ...`` starts them, a few
iterations at a narrow width. Rank 0 alone writes the run directory and
its log.
"""

import glob
import os

import pytest

import _torch_dist
from _torch_threads import one_thread  # noqa: F401

RUNS = {
    "composed": (4, "graphical_gan_tpu_torch.runs.gan_inference",
                 ["--dataset", "mnist", "--mode", "ali", "--iters", "3",
                  "--dim", "8", "--batch-size", "4", "--device", "cpu",
                  "--checkpoint-every", "0", "--parallel", "composed",
                  "--mesh-shape", "data=2,model=2"]),
    "ep": (2, "graphical_gan_tpu_torch.runs.gmgan",
           ["--dataset", "mnist", "--mode", "local_ep", "--n-coms", "6",
            "--iters", "3", "--dim", "8", "--batch-size", "4", "--device",
            "cpu", "--checkpoint-every", "0", "--eval-every", "2",
            "--n-devices", "2", "--parallel", "ep", "--mesh-shape", "1,2"]),
    "sp": (2, "graphical_gan_tpu_torch.runs.ssgan",
           ["--dataset", "moving_mnist", "--seq-len", "4", "--dim", "4",
            "--batch-size", "2", "--iters", "3", "--device", "cpu",
            "--eval-every", "2", "--data-pipeline", "resident",
            "--n-devices", "2", "--parallel", "sp", "--mesh-shape", "1,2"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = {}
    for name, (world, module, argv) in RUNS.items():
        out = str(tmp_path_factory.mktemp(name))
        jobs[name] = (out, _torch_dist.start(
            "cli_worker", world,
            {"module": module, "argv": argv + ["--outdir", out]},
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
    if name == "ep":
        assert "testing accuracy" in log and "tsne skipped" in log
    if name == "sp":
        assert "Number of parameters in each player" in log
