"""The GMGAN entry point, hooks, serving and tools on the CPU
(``graphical_gan_tpu_torch/runs/gmgan.py``, ``serve/``,
``tools/generate.py``), at dim 8 and 5 components: the CLI trains and
resumes with the grid, reconstruction and clustering-accuracy hooks and
the TSNE skip line of a machine without sklearn; the per-component grid's
inputs are JAX's; the cluster entry and the one-hot prior through the
HTTP server; the mixture-prior inception hook with a given classifier;
the generate tool's grids for both families."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.core.config import asdict, gmgan_defaults
from graphical_gan_tpu_torch.models.gmgan import GMGanModel
from graphical_gan_tpu_torch.report.save_images import png_size
from graphical_gan_tpu_torch.runs import gmgan as port_run
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from _torch_threads import one_thread  # noqa: F401

TINY = ["--dim", "8", "--n-coms", "5", "--device", "cpu"]


def _run_dir(path, mode="local_ep", **kw):
    cfg = gmgan_defaults("mnist", mode, dim=8, batch_size=8, n_coms=5, **kw)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(asdict(cfg), f)
    model = GMGanModel(cfg)
    params = model.init(seed=0, device="cpu")
    ckpt_lib.save_params(os.path.join(path, "ckpt_4.npz"), params,
                         {"iteration": 4})
    return cfg, model, params


def test_cli_trains_with_its_hooks_and_resumes(tmp_path, capsys,
                                               monkeypatch):
    """``--data-dir structured`` at 200 train and 50 dev and test rows."""
    monkeypatch.setattr(port_run, "_missing_module",
                        lambda names: "sklearn.manifold: not here")
    small = port_run._structured_loaders
    monkeypatch.setattr(port_run, "_structured_loaders",
                        lambda cfg: small(cfg, n_train=200, n_eval=50))
    from graphical_gan_tpu_torch.runs.gmgan_inference_mnist import main
    run_dir = str(tmp_path / "run")
    common = TINY + ["--mode", "alice", "--mode-k", "REINFORCE",
                     "--run-dir", run_dir, "--eval-every", "2",
                     "--checkpoint-every", "2", "--data-dir", "structured"]
    main(common + ["--iters", "3"])
    out = capsys.readouterr().out
    assert "iter 2\t" in out and "testing accuracy" in out
    assert "tsne skipped: sklearn.manifold: not here" in out
    files = set(os.listdir(run_dir))
    assert {"config.json", "logfile.txt", "ckpt_1.npz", "ckpt_2.npz",
            "1_samples_alice.png", "1_reconstruction_alice.png"} <= files
    # n_vis 300 over 5 components: 60 rows of 5 samples, 28x28, gray
    assert png_size(os.path.join(run_dir, "1_samples_alice.png")) == \
        (5 * 28, 60 * 28, 0)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["mode"], cfg["mode_k"], cfg["n_coms"]) == \
        ("alice", "REINFORCE", 5)
    main(common + ["--iters", "5"])
    out = capsys.readouterr().out
    assert "iter 2\t" not in out and "iter 4\t" in out
    assert "ckpt_4.npz" in os.listdir(run_dir)


def test_grid_inputs_are_the_jax_hook_s():
    """n_vis rounded down to the components, RandomState(0)'s noise, each
    row one noise vector across every component."""
    k, noise = port_run.grid_inputs(gmgan_defaults("mnist", n_coms=7))
    assert k.shape == (294, 7) and noise.shape == (294, 128)
    np.testing.assert_array_equal(k[:7], np.eye(7))
    np.testing.assert_array_equal(
        noise, np.random.RandomState(0).normal(size=(294, 128)).astype(
            "float32"))


def test_cluster_entry_and_onehot_prior_over_http(tmp_path):
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import (
        BatchingSampler, _draw_prior, make_http_server, sampler_from_run_dir)
    cfg, model, params = _run_dir(str(tmp_path / "run"))
    prior = _draw_prior(["onehot", "normal"], [(8, 5), (8, 128)], 400, 3)
    assert prior[0].shape == (400, 5) and prior[1].shape == (400, 128)
    assert set(np.unique(prior[0])) == {0.0, 1.0}
    assert (prior[0].sum(axis=1) == 1).all()
    assert (prior[0].sum(axis=0) > 40).all()  # every component drawn
    servers = {}
    for entry in ("sampler", "cluster"):
        call, kinds, shapes, ident = sampler_from_run_dir(
            str(tmp_path / "run"), entry=entry, device="cpu")
        b = BatchingSampler(call, kinds, shapes, buckets=(4, 8),
                            max_wait_ms=20.0)
        httpd = make_http_server(b, ident, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers[entry] = (httpd, b)
    try:
        url = "http://127.0.0.1:{}"
        sam = SamplerClient(url.format(
            servers["sampler"][0].server_address[1]))
        assert sam.healthz()["family"] == "gmgan"
        img = sam.sample(n=6, seed=2)
        assert img.shape == (6, 784) and (img >= 0).all() and (img <= 1).all()
        clu = SamplerClient(url.format(
            servers["cluster"][0].server_address[1]))
        assert clu.healthz()["output"] == "probs"
        x = np.random.default_rng(0).random((8, 784), dtype=np.float32)
        probs = clu.sample(inputs=[x], seed=1, exact=True)
        with torch.no_grad():
            want = model.cluster_probs(params, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(probs, want)
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
        batched = clu.sample(inputs=[x], seed=1)
        np.testing.assert_array_equal(batched, want)
    finally:
        for httpd, b in servers.values():
            httpd.shutdown()
            httpd.server_close()
            b.close()


def test_mixture_inception_hook_scores_prior_samples(tmp_path):
    import types
    cfg = gmgan_defaults("cifar10", dim=8, batch_size=4, n_coms=5)
    model = GMGanModel(cfg)
    seen = []

    def classifier(images):
        seen.append(np.asarray(images).shape)
        return np.full((len(images), 10), 0.1, np.float32)

    plots = {}
    trainer = types.SimpleNamespace(
        params=model.init(0, "cpu"), device=torch.device("cpu"),
        logger=types.SimpleNamespace(plot=plots.__setitem__),
        eval_generator=lambda salt, it: torch.Generator().manual_seed(salt))
    port_run.make_gmgan_inception_hook(model, n_samples=250,
                                       sample_batch=100,
                                       classifier=classifier)(trainer, 9)
    imgs = port_run.mixture_samples(model, trainer.params, 7, 5,
                                    torch.Generator().manual_seed(0))
    assert len(imgs) == 7 and imgs[0].shape == (32, 32, 3)
    assert min(i.min() for i in imgs) >= 0 and max(i.max() for i in imgs) \
        <= 255
    assert plots["inception score"] == pytest.approx(1.0)
    assert sum(s[0] for s in seen) == 250


@pytest.mark.parametrize("family", ["gmgan", "gan_inference"])
def test_generate_writes_the_family_s_grids(tmp_path, family, capsys):
    from graphical_gan_tpu_torch.tools.generate import main
    run_dir = str(tmp_path / "run")
    if family == "gmgan":
        _run_dir(run_dir)
        want = {"4_samples_local_ep.png": (5 * 28, 60 * 28, 0),
                "4_reconstruction_local_ep.png": None}
    else:
        from graphical_gan_tpu_torch.core.config import (
            gan_inference_defaults)
        from graphical_gan_tpu_torch.models.gan_inference import (
            GanInferenceModel)
        cfg = gan_inference_defaults("mnist", "ali", dim=8, batch_size=8)
        os.makedirs(run_dir)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(asdict(cfg), f)
        ckpt_lib.save_params(os.path.join(run_dir, "ckpt_4.npz"),
                             GanInferenceModel(cfg).init(0, "cpu"),
                             {"iteration": 4})
        want = {"ali_mnist_samples_4.png": (10 * 28, 10 * 28, 0),
                "ali_mnist_reconstruction_4.png": None}
    info = main(["--run-dir", run_dir, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == info
    assert (info["family"], info["iteration"]) == (family, 4)
    assert set(want) <= set(info["artifacts"])
    for name, size in want.items():
        got = png_size(os.path.join(info["outdir"], name))
        assert size is None or got == size
