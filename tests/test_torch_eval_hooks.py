"""The port's eval hooks and the trainer around them (graphical_gan_tpu_
torch/runs/gan_inference.py, train/trainer.py) at dim 8, B 4, with the
weights handed to both packages (``tests/_torch_family1.py: models``):

- the sample grid's float image is the JAX hook's before quantization
  (1e-4 of the largest |value|), and the port's PNG is within 1 of the
  JAX hook's PNG per pixel;
- the reconstruction grid, with the JAX hook's draws handed in (celeba's
  dequantization, a learn_std posterior's eps), is the JAX hook's;
- the structured quality hook logs finite ``fid`` / ``inception score`` /
  accuracy values; the TSNE hook plots where sklearn is, and logs its skip
  once where it is not; the cifar10 inception hook logs a skip without a
  classifier or without local weights, and builds its classifier on the
  trainer's device;
- the dev sweep logs the mean of the port's ``gen_loss`` over the dev
  batches (rec/reg where the mode has a reconstruction term);
- hooks fire at ``iteration % every == every - 1`` after the window's
  flush, and what they plot at the last boundary reaches the log;
- a ``--data-pipeline host`` CLI run and its resume write what the
  resident path's run directory holds.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.runs import gan_inference as jax_run
from graphical_gan_tpu_torch.runs import gan_inference as port_run
from graphical_gan_tpu_torch.train.trainer import DEV_SALT, Trainer
from tests._torch_family1 import B, _Stream, models

ARGS = ["--dim", "8", "--batch-size", "4", "--device", "cpu"]


def _jax_images(jm, jp, fixed_dev):
    """The JAX hook's float images: samples of RandomState(0)'s noise, and
    the interleaved data/reconstruction rows (its keys 0, 1 and 2)."""
    cfg = jm.cfg
    noise = np.random.RandomState(0).normal(
        size=(cfg.n_vis, cfg.dim_latent)).astype("float32")
    s = registry.jit_apply(jm.sample)(jp, jax.random.PRNGKey(0),
                                      jnp.asarray(noise))
    samples = jax_run._to_grid_scale(cfg, np.asarray(s)).reshape(
        jax_run._grid_shape(cfg, cfg.n_vis))
    x = jnp.asarray(fixed_dev)
    rec = jax_run._to_grid_scale(cfg, np.asarray(registry.jit_apply(
        jm.reconstruct)(jp, jax.random.PRNGKey(1), x)))
    data = jax_run._to_grid_scale(cfg, np.asarray(registry.jit_apply(
        jm.normalize)(jp, jax.random.PRNGKey(2), x)))
    inter = np.stack([data, rec], axis=1).reshape(-1, data.shape[-1])
    return samples, inter.reshape(jax_run._grid_shape(cfg, 2 * len(x)))


def _hook_draws(cfg, batch):
    """The draws the JAX hook's reconstruct (key 1) and normalize (key 2)
    make, by the port's names."""
    out = {}
    for part, key in (("rec", 1), ("norm", 2)):
        s = _Stream(jax.random.PRNGKey(key))
        d = {}
        if cfg.data.normalization == "dequant":
            d["dequant"] = jax.random.uniform(s.next(),
                                              (batch, cfg.data.output_dim))
        if part == "rec" and cfg.type_q in ("learn_std", "fix_std") \
                and cfg.dataset != "celeba":
            d["eps_q"] = jax.random.normal(s.next(), (batch, cfg.dim_latent))
        out[part] = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    return out


def _raw(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.data.normalization == "unit":
        return rng.random((B, cfg.data.output_dim), dtype=np.float32)
    return rng.integers(0, 256, (B, cfg.data.output_dim)).astype(np.int32)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dataset,mode", [
    ("cifar10", "wali-gp"), ("mnist", "vae"), ("celeba", "ali")])
def test_grids_are_the_jax_hook_s(tmp_path, dataset, mode):
    jm, tm, jp, tp = models(dataset, mode)
    cfg = tm.cfg
    fixed_dev = _raw(cfg)
    want_s, want_r = _jax_images(jm, jp, fixed_dev)
    noise = np.random.RandomState(0).normal(
        size=(cfg.n_vis, cfg.dim_latent)).astype("float32")
    got_s, got_r = port_run.grid_images(tm, tp, noise, fixed_dev,
                                        draws=_hook_draws(cfg, B))
    assert got_s.shape == want_s.shape and got_r.shape == want_r.shape
    assert _max_rel(got_s, want_s) < 1e-4
    assert _max_rel(got_r, want_r) < 1e-4


@pytest.mark.parametrize("dataset,mode", [("cifar10", "wali-gp"),
                                          ("mnist", "ali")])
def test_sample_png_is_within_one_of_the_jax_png(tmp_path, dataset, mode):
    jm, tm, jp, tp = models(dataset, mode)
    fixed_dev = _raw(tm.cfg)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_run.make_eval_hooks(jm, fixed_dev)(
        SimpleNamespace(params=jp, outf=str(tmp_path / "jax")), 4)
    trainer = SimpleNamespace(
        params=tp, outf=str(tmp_path / "port"),
        eval_generator=lambda salt, it: torch.Generator().manual_seed(7))
    port_run.make_eval_hooks(tm, fixed_dev)(trainer, 4)
    for kind in ("samples", "reconstruction"):
        name = f"{mode}_{dataset}_{kind}_4.png"
        with Image.open(tmp_path / "jax" / name) as a, \
                Image.open(tmp_path / "port" / name) as b:
            want, got = np.asarray(a), np.asarray(b)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A cifar10 wali-gp trainer after 1 iteration on a few images."""
    _, tm, _, tp = models("cifar10", "wali-gp")
    data = np.concatenate([_raw(tm.cfg, seed=i) for i in range(4)])
    tr = Trainer(tm, data, str(tmp_path_factory.mktemp("trained")),
                 device="cpu", checkpoint_every=0)
    tr.state = tr.init_state(tp)
    tr.train(1)
    return tr


def test_structured_quality_hook_logs_finite_scores(trained):
    cfg = trained.cfg
    _, _, pools_ = port_run._structured_pool(cfg, n_train=300, n_eval=40)
    hook = port_run.make_structured_quality_hook(
        trained.model, pools_, n_score=200, clf_steps=5)
    hook(trained, 9)
    line = trained.logger.flush()
    vals = dict(zip(line.split("\t")[1::2],
                    map(float, line.split("\t")[2::2])))
    for name in ("fid", "inception score", "inception score std",
                 "metric classifier heldout acc"):
        assert np.isfinite(vals[name]), name
    assert vals["inception score"] >= 1.0 and vals["fid"] >= 0.0


def test_inception_hook_logs_a_skip_without_a_classifier(trained,
                                                         monkeypatch):
    from graphical_gan_tpu_torch.metrics import inception

    def none(device):
        raise ImportError("no torchvision")

    monkeypatch.setattr(inception, "default_is_classifier", none)
    port_run.make_inception_hook(trained.model, n_samples=10)(trained, 9)
    assert "inception score skipped\t0.0" in trained.logger.flush()


def test_inception_hook_skips_where_no_weights_are_on_the_machine(
        trained, tmp_path, monkeypatch):
    """No weights file: the classifier raises before building a model
    (nothing is fetched), and the hook logs its skip."""
    from graphical_gan_tpu_torch.metrics import inception
    missing = tmp_path / inception.INCEPTION_V3_FILE
    monkeypatch.setenv("GGAN_INCEPTION_PB", str(tmp_path / "none.pb"))
    monkeypatch.setenv("GGAN_INCEPTION_WEIGHTS", str(missing))
    with pytest.raises(FileNotFoundError, match=str(missing)):
        inception.default_is_classifier("cpu")
    port_run.make_inception_hook(trained.model, n_samples=10)(trained, 9)
    assert "inception score skipped\t0.0" in trained.logger.flush()


def test_inception_hook_builds_its_classifier_on_the_trainer_device(
        trained, monkeypatch):
    """The hook's classifier is built on the trainer's device and scores
    ``n_samples`` samples in [0, 255]."""
    from graphical_gan_tpu_torch.metrics import inception
    devices, seen = [], []

    def uniform(images):
        seen.append(images.shape)
        assert images.min() >= 0 and images.max() <= 255
        return np.full((len(images), 10), 0.1)

    def build(device):
        devices.append(device)
        return uniform

    monkeypatch.setattr(inception, "default_is_classifier", build)
    port_run.make_inception_hook(trained.model, n_samples=10,
                                 sample_batch=4)(trained, 9)
    assert devices == [trained.device]
    assert sum(s[0] for s in seen) == 10
    vals = trained.logger.flush()
    assert "inception score\t1.0" in vals


def _labelled_dev(cfg, n=40):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (n, cfg.data.output_dim)).astype(np.int32)
    y = rng.integers(0, 10, n)

    def factory():
        for i in range(0, n, 8):
            yield x[i:i + 8], y[i:i + 8]
    return factory


def test_tsne_hook_plots_the_dev_codes(trained):
    hook = port_run.make_tsne_hook(trained.model, _labelled_dev(trained.cfg))
    hook(trained, 9)
    assert os.path.getsize(os.path.join(
        trained.outf, "wali-gp_cifar10_manifold_9.png")) > 0


def test_tsne_hook_logs_its_skip_once_without_sklearn(trained, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "sklearn.manifold", None)
    hook = port_run.make_tsne_hook(trained.model, _labelled_dev(trained.cfg))
    hook(trained, 19)
    hook(trained, 29)
    with open(trained.logfile) as f:
        skips = [ln for ln in f if ln.startswith("tsne skipped: ")]
    assert len(skips) == 1 and "sklearn.manifold" in skips[0]
    assert not os.path.exists(os.path.join(
        trained.outf, "wali-gp_cifar10_manifold_19.png"))


@pytest.mark.parametrize("mode", ["wali-gp", "alice"])
def test_dev_sweep_logs_the_mean_gen_loss(tmp_path, mode):
    _, tm, _, tp = models("cifar10", mode)
    dev = [_raw(tm.cfg, seed=i) for i in range(3)]
    tr = Trainer(tm, np.concatenate(dev), str(tmp_path), device="cpu",
                 dev_gen_factory=lambda: iter(dev))
    tr.state = tr.init_state(tp)
    tr._dev_sweep(99)
    line = tr.logger.flush()
    gen = tr.eval_generator(DEV_SALT, 99)
    gens, recs = [], []
    with torch.no_grad():
        for x in dev:
            g, aux = tm.gen_loss(tp, torch.from_numpy(x), generator=gen)
            gens.append(float(g))
            recs.append(float(aux.get("rec_cost", np.nan)))
    vals = dict(zip(line.split("\t")[1::2],
                    map(float, line.split("\t")[2::2])))
    if mode == "alice":
        assert vals["dev rec cost"] == pytest.approx(np.mean(recs),
                                                     rel=1e-6)
        assert vals["dev reg cost"] == pytest.approx(
            np.mean(gens) - np.mean(recs), rel=1e-5, abs=1e-6)
        assert "dev gen cost" not in vals
    else:
        assert vals["dev gen cost"] == pytest.approx(np.mean(gens),
                                                     rel=1e-6)


def test_hooks_fire_after_the_flush_and_reach_the_log(tmp_path):
    _, tm, _, tp = models("cifar10", "wali-gp")
    fired = []

    def hook(trainer, iteration):
        fired.append(iteration)
        trainer.logger.plot("hook value", float(iteration))

    data = np.concatenate([_raw(tm.cfg, seed=i) for i in range(4)])
    tr = Trainer(tm, data, str(tmp_path), device="cpu", checkpoint_every=0,
                 eval_hooks={3: hook, 0: hook})
    tr.state = tr.init_state(tp)
    tr.train(6)
    assert fired == [2, 5]
    with open(tr.logfile) as f:
        log = f.read()
    # iteration 2's value goes out with iteration 3's flush, and the last
    # one in the final flush
    assert "hook value\t2.0" in log and "hook value\t5.0" in log


def _write_cifar10(dirpath, rows=12):
    rng = np.random.default_rng(5)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(dirpath, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (rows, 3072),
                                              dtype=np.uint8),
                         "labels": rng.integers(0, 10, rows).tolist()}, f)


def test_host_pipeline_cli_run_and_resume_write_the_run_directory(tmp_path):
    """60 train rows: 15 batches of 4, so the 6-batch iterations cross
    epochs."""
    data = tmp_path / "data"
    data.mkdir()
    _write_cifar10(data)
    out = tmp_path / "out"
    port_run.main(["--dataset", "cifar10", "--mode", "wali-gp",
                   "--iters", "3", "--data-pipeline", "host",
                   "--data-dir", str(data), "--outdir", str(out)] + ARGS)
    (d,) = os.listdir(out)
    run_dir = os.path.join(out, d)
    assert sorted(os.listdir(run_dir)) == ["ckpt_2.npz", "config.json",
                                           "logfile.txt"]
    port_run.main(["--dataset", "cifar10", "--mode", "wali-gp",
                   "--iters", "5", "--data-pipeline", "host",
                   "--data-dir", str(data), "--run-dir", run_dir] + ARGS)
    assert "ckpt_4.npz" in os.listdir(run_dir)
    with open(os.path.join(run_dir, "logfile.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("iter ")]
    assert [ln.split("\t")[0] for ln in lines] == [
        f"iter {i}" for i in range(5)]
    costs = [float(ln.split("train disc cost\t")[1].split("\t")[0])
             for ln in lines]
    assert np.isfinite(costs).all()
