"""The family-1 training CLI on 2 gloo ranks on the CPU under tp (mnist
wali-gp: the penalty through D's BNs on sharded channels), as ``torchrun
--nproc-per-node 2 -m graphical_gan_tpu_torch.runs.gan_inference --device
cpu --n-devices 2 --parallel tp ...`` starts it, a few iterations at a
narrow width (``test_torch_parallel_cli.py`` runs dp,
``test_torch_parallel_cli_families.py`` the other CLIs and composed).
Rank 0 alone writes the run directory. The checkpoint of the sharded
run is the full state in the JAX npz layout, and JAX's
``checkpoint.restore`` reads it into its own ``init_state``.
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
    "tp": (2, GAN, ["--dataset", "mnist", "--mode", "wali-gp",
                    "--n-devices", "2", "--parallel", "tp",
                    "--mesh-shape", "1,2"]),
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


def test_sharded_checkpoint_restores_in_jax(runs):
    """The TP run's checkpoint (gathered from the ranks' halves) into
    JAX's mnist wali-gp ``init_state``: every leaf whole and finite."""
    import jax
    from graphical_gan_tpu.core.config import gan_inference_defaults
    from graphical_gan_tpu.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu.train import checkpoint as jax_ckpt
    from graphical_gan_tpu.train.step import make_train_step
    out, _ = runs["tp"]
    path = glob.glob(os.path.join(out, "*", "ckpt_2.npz"))[0]
    model = GanInferenceModel(gan_inference_defaults("mnist", "wali-gp",
                                                     dim=8, batch_size=4))
    _, init_state = make_train_step(model, jit=False)
    # the state's structure and shapes, traced (no values computed)
    like = jax.eval_shape(lambda: init_state(model.init(
        jax.random.PRNGKey(0))))
    state, extra = jax_ckpt.restore(path, like)
    assert int(extra["iteration"]) == 2
    for leaf, ref in zip(jax.tree.leaves(state), jax.tree.leaves(like)):
        assert np.shape(leaf) == tuple(ref.shape)
        assert np.isfinite(np.asarray(leaf, np.float32)).all()
