"""The port's trainer and CLI (graphical_gan_tpu_torch/train/trainer.py,
runs/gan_inference.py) on the CPU at dim 8, B 4: a 3-iteration run writes
config.json, logfile.txt and a whole-state ckpt_2.npz; the JAX package's
``checkpoint.restore`` reads that checkpoint into its own ``init_state``
structure and the port reads a JAX checkpoint; ``--run-dir`` resumes at the
last iteration + 1 and draws what an uninterrupted run draws; the port's
server loads the run directory; and the trainer sets the port's numerics.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu.train import checkpoint as jax_ckpt
from graphical_gan_tpu.train.step import make_train_step as jax_make_step
from graphical_gan_tpu_torch.core import device as port_device
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.runs.gan_inference import main, run
from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.step import make_train_step

ARGS = ["--dataset", "cifar10", "--mode", "wali-gp", "--dim", "8",
        "--batch-size", "4", "--device", "cpu"]
KW = dict(dim=8, batch_size=4)
CIFAR = dict(dataset="cifar10", mode="wali-gp")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    main(ARGS + ["--iters", "3", "--outdir", str(out)])
    (d,) = os.listdir(out)
    return os.path.join(out, d)


def _jax_like(params_np):
    jm = JaxM(jax_cfg("cifar10", "wali-gp", **KW))
    _, init_state = jax_make_step(jm, jit=False)
    return init_state({k: jnp.asarray(v) for k, v in params_np.items()})


def test_cli_writes_the_run_directory(run_dir):
    assert os.path.basename(run_dir).startswith(
        "gan_inference_cifar10.MODE-wali-gp.")
    assert sorted(os.listdir(run_dir)) == ["ckpt_2.npz", "config.json",
                                           "logfile.txt"]
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["dim"], cfg["batch_size"], cfg["mode"]) == (8, 4, "wali-gp")
    with open(os.path.join(run_dir, "logfile.txt")) as f:
        log = f.read()
    assert "\tDIM: 8\n" in log and "Total number of parameters" in log
    lines = [ln for ln in log.splitlines() if ln.startswith("iter ")]
    assert [ln.split("\t")[0] for ln in lines] == ["iter 0", "iter 1",
                                                    "iter 2"]
    costs = [float(ln.split("train disc cost\t")[1].split("\t")[0])
             for ln in lines]
    assert all(np.isfinite(costs))
    _, extra = ckpt_lib.load_raw(os.path.join(run_dir, "ckpt_2.npz"))
    assert extra["iteration"] == 2


def test_jax_restores_the_port_checkpoint(run_dir):
    path = os.path.join(run_dir, "ckpt_2.npz")
    flat, _ = ckpt_lib.load_raw(path)
    like = _jax_like(ckpt_lib.params_of(flat))
    state, extra = jax_ckpt.restore(path, like)
    assert int(state.step) == 3 and int(state.gen_opt["t"]) == 2
    assert int(state.disc_opt["t"]) == 15
    np.testing.assert_array_equal(
        np.asarray(state.disc_opt["v"]["Discriminator.1.Filters"]),
        flat["n:disc_opt|k:v|k:Discriminator.1.Filters"])
    assert extra["iteration"] == 2


def test_port_restores_a_jax_checkpoint(tmp_path):
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp", **KW))
    params = {k: v.numpy() for k, v in tm.init(1, "cpu").items()}
    jstate = _jax_like(params)
    jstate = jstate._replace(
        step=jnp.asarray(9, jnp.int32),
        gen_opt=dict(jstate.gen_opt, t=jnp.asarray(8, jnp.int32)))
    path = str(tmp_path / "ckpt_8.npz")
    jax_ckpt.save(path, jstate, {"iteration": 8})
    _, init_state = make_train_step(tm)
    like = init_state(tm.init(0, "cpu"))
    state, extra = ckpt_lib.restore_state(path, like)
    assert state.step == 9 and int(state.gen_opt["t"]) == 8
    assert extra == {"iteration": 8}
    for name, arr in params.items():
        np.testing.assert_array_equal(state.params[name].numpy(), arr)
    # and state_from_jax carries the same state straight from memory
    direct = ckpt_lib.state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert direct.step == 9 and direct.gen_opt["t"].device.type == "cpu"
    restored = ckpt_lib.state_leaves(state)
    assert set(ckpt_lib.state_leaves(direct)) == set(restored)
    for key, leaf in ckpt_lib.state_leaves(direct).items():
        assert torch.equal(leaf, restored[key]), key


def test_run_dir_resumes_and_draws_as_one_run(tmp_path):
    straight, _ = run(iters=4, outdir=str(tmp_path / "a"), device="cpu",
                      checkpoint_every=2, **CIFAR, **KW)
    first, _ = run(iters=2, outdir=str(tmp_path / "b"), device="cpu",
                   **CIFAR, **KW)
    resumed, _ = run(iters=4, run_dir=first.outf, device="cpu", **CIFAR,
                     **KW)
    assert resumed._start_iter == 2 and resumed.state.step == 4
    for name, p in straight.state.params.items():
        assert torch.equal(resumed.state.params[name], p), name
    with open(os.path.join(first.outf, "logfile.txt")) as f:
        iters = [ln.split("\t")[0] for ln in f if ln.startswith("iter ")]
    assert iters == ["iter 0", "iter 1", "iter 2", "iter 3"]
    assert [s for s, _ in ckpt_lib.list_checkpoints(first.outf)] == [1, 3]


def test_port_server_loads_the_run_directory(run_dir):
    call, kinds, _, _ = sampler_from_run_dir(run_dir, entry="reconstructor",
                                             device="cpu")
    out = call(0, np.zeros((4, 3072), np.float32))
    assert kinds == ["image"] and out.shape == (4, 3072)
    assert np.isfinite(out).all()


def test_trainer_sets_the_numerics(tmp_path, monkeypatch):
    for flag, value in ((torch.backends.cudnn, "allow_tf32"),
                        (torch.backends.cuda.matmul, "allow_tf32")):
        monkeypatch.setattr(flag, value, True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    run(iters=1, outdir=str(tmp_path), device="cpu", **CIFAR, **KW)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is True
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    port_device.set_numerics()
    assert torch.backends.cudnn.deterministic is True


def test_structured_data_is_the_jax_family():
    from graphical_gan_tpu.data import synthetic as jax_synth
    a, ya = synthetic.structured_images_labeled(40, seed=3)
    b, yb = jax_synth.structured_images_labeled(40, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(synthetic.images_int(5, 12, 2),
                                  jax_synth.images_int(5, 12, 2))


@pytest.mark.parametrize("overrides", [dict(accum_steps=2), dict(remat=True)])
def test_later_step_options_raise(overrides):
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp", **KW,
                                                  **overrides))
    with pytest.raises(NotImplementedError, match="later slice"):
        make_train_step(tm)


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--iters", "1", "--dim", "8", "--batch-size", "4",
              "--outdir", str(tmp_path)])
