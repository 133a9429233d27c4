"""int8 serving through the port's server and tools, on the CPU.

- ``serve/server.py --quantize int8``: the HTTP front serves the quantized
  sampler (batched and exact requests, the identity says ``int8``), its
  exact outputs equal the quantized sampler called directly with the
  server's calibration (seed 11), and ``--quantize`` refuses the image
  entries and unknown modes as the JAX server does.
- ``tools/bench_serving.py`` and ``tools/bench_server.py`` take
  ``--quantize int8``; ``bench_serving --via-export`` times the exported
  program.
- ``tools/score_samples.py``: a metric classifier written by the JAX
  package (``checkpoint.save`` of its ``MetricClassifier``) loads into the
  port and gives JAX's probabilities; the CLI scores float and int8
  samples at n = 40; ``--classifier frozen`` reads the ``.pb`` it is
  given (tests/test_torch_inception_frozen.py scores with one).
- ``tools/quality_ab.py`` at n = 40 with 5 classifier steps: one line per
  arm and the delta line.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.core.config import (
    asdict as port_asdict, gan_inference_defaults)
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.ops import quant
from graphical_gan_tpu_torch.serve.client import SamplerClient
from graphical_gan_tpu_torch.serve.export import make_sampler
from graphical_gan_tpu_torch.serve.quantize import calibrate
from graphical_gan_tpu_torch.serve.server import (
    sampler_from_run_dir, serve_run_dir)
from graphical_gan_tpu_torch.tools import (
    bench_server, bench_serving, quality_ab, score_samples)
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

from _torch_threads import one_thread  # noqa: F401

TINY = ["--device", "cpu", "--dim", "4"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A cifar10 wali-gp run directory (BN on) at dim 8, random weights."""
    path = str(tmp_path_factory.mktemp("q") / "run")
    cfg = gan_inference_defaults("cifar10", "wali-gp", dim=8, batch_size=8)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(port_asdict(cfg), f)
    model = GanInferenceModel(cfg)
    params = model.init(seed=0, device="cpu")
    ckpt_lib.save_params(os.path.join(path, "ckpt_3.npz"), params,
                         {"iteration": 3})
    return path, model, params


def test_server_quantize_int8_over_http(run_dir):
    path, model, params = run_dir
    httpd, batcher, identity, _ = serve_run_dir(
        path, device="cpu", buckets=(4, 8), port=0, quantize="int8")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert identity["quantization"] == "int8"
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        client = SamplerClient(url)
        assert client.healthz()["quantization"] == "int8"
        out = client.sample(n=5, seed=3)
        assert out.shape == (5, 3072) and np.isfinite(out).all()
        exact = client.sample(n=4, seed=9, exact=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    # the exact request is the quantized sampler on the server's draws
    scales = calibrate("gan_inference", model, params, 11)
    from graphical_gan_tpu_torch.serve.server import _draw_prior
    (z,) = _draw_prior(["normal"], [(8, model.cfg.dim_latent)], 4, 9)
    fn = make_sampler("gan_inference", model)[0]
    with torch.inference_mode(), quant.quantized(scales):
        want = fn(params, 9, torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(exact, want)
    with torch.inference_mode():
        flt = fn(params, 9, torch.from_numpy(z)).numpy()
    assert np.abs(exact - flt).max() > 1e-3


def test_server_quantize_refusals(run_dir):
    path = run_dir[0]
    with pytest.raises(ValueError, match="sampler entry only"):
        sampler_from_run_dir(path, entry="encoder", device="cpu",
                             quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        sampler_from_run_dir(path, device="cpu", quantize="int4")
    from graphical_gan_tpu_torch.serve.server import main
    with pytest.raises(SystemExit):
        main(["--run-dir", path, "--quantize", "int4"])


def test_bench_tools_take_quantize_int8(capsys):
    assert bench_serving.main(["--families", "gan_inference,ssgan",
                               "--batches", "2", "--depth", "1",
                               "--rounds", "1", "--quantize", "int8"]
                              + TINY) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["quantize"] for r in recs] == ["int8", "int8"]
    assert all(r["latency_ms"] > 0 for r in recs)
    with pytest.raises(ValueError, match="sampler entry only"):
        bench_serving.measure("gmgan", [2], 1, 1, "cluster", device="cpu",
                              quantize="int8", dim=4)
    assert bench_server.main(["--request-sizes", "2", "--clients", "2",
                              "--requests-per-client", "2", "--buckets",
                              "2,4", "--quantize", "int8"] + TINY) == 0
    (rec,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rec["quantization"] == "int8" and rec["requests"] == 4


def test_jax_metric_classifier_loads_into_the_port(tmp_path):
    """An npz the JAX package's ``checkpoint.save`` writes of a metric
    classifier's parameters (tests/test_torch_metric_classifier.py holds
    the port's classifier to JAX's on the same parameters)."""
    import jax.numpy as jnp
    from graphical_gan_tpu.train import checkpoint as jax_ckpt
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    clf = MetricClassifier(dim=8, device="cpu")
    params = clf.init(3)
    path = str(tmp_path / "clf.npz")
    jax_ckpt.save(path, {k: jnp.asarray(v.numpy())
                         for k, v in params.items()}, {"dim": 8})
    prob_fn, ident = score_samples.make_classifier(
        "jax", path, (32, 32), 3, clf_dim=8, device="cpu")
    assert ident == f"jax-metric-classifier:{path}"
    imgs = np.random.default_rng(0).random((6, 32, 32, 3)) * 255
    np.testing.assert_array_equal(prob_fn(imgs),
                                  clf.as_prob_fn(params)(imgs))
    with pytest.raises(FileNotFoundError):  # the frozen graph's .pb
        score_samples.make_classifier("frozen", str(tmp_path / "x.pb"),
                                      (32, 32), 3, device="cpu")
    jax_ckpt.save(path, {"Classifier.1.Filters": jnp.zeros((3, 3, 3, 8))})
    with pytest.raises(KeyError, match="lacks the classifier's"):
        score_samples.make_classifier("jax", path, (32, 32), 3, clf_dim=8,
                                      device="cpu")


def test_score_samples_float_and_int8(run_dir, tmp_path, capsys):
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    path, model, params = run_dir
    clf = MetricClassifier(dim=8, device="cpu")
    clf_path = str(tmp_path / "clf.npz")
    ckpt_lib.save_dict(clf_path, clf.init(0))
    base = ["--ckpt", os.path.join(path, "ckpt_3.npz"), "--dataset",
            "cifar10", "--mode", "wali-gp", "--dim", "8", "--n-samples",
            "40", "--splits", "2", "--classifier", "jax",
            "--classifier-ckpt", clf_path, "--classifier-dim", "8",
            "--device", "cpu"]
    flt = score_samples.main(base)
    q = score_samples.main(base + ["--quantize", "int8"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [flt, q]
    assert (flt["quantize"], q["quantize"]) == ("none", "int8")
    assert flt["n_samples"] == q["n_samples"] == 40
    assert flt["ckpt_iteration"] == 3
    assert np.isfinite(flt["inception_score"]) and \
        np.isfinite(q["inception_score"])
    a = score_samples.draw_samples(model, params, 40, batch=20)
    b = score_samples.draw_samples(
        model, params, 40, batch=20,
        quantize_scales=calibrate("gan_inference", model, params, 1234))
    assert np.asarray(a).shape == (40, 32, 32, 3)
    assert 0 < np.abs(np.asarray(a) - np.asarray(b)).max() <= 255


def test_quality_ab_prints_both_arms_and_the_delta(run_dir, capsys,
                                                   monkeypatch):
    import functools
    from graphical_gan_tpu_torch.runs import gan_inference
    # a smaller structured pool than the hook's 20,000 + 2,000 rows: the
    # instrument is the same, drawn from fewer rows
    monkeypatch.setattr(gan_inference, "_structured_pool", functools.partial(
        gan_inference._structured_pool, n_train=400, n_eval=100))
    path = run_dir[0]
    out = quality_ab.main(["--ckpt", os.path.join(path, "ckpt_3.npz"),
                           "--dim", "8", "--n-samples", "40",
                           "--clf-steps", "5", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["instrument"] == "structured-metric-classifier"
    assert [ln["arm"] for ln in lines[1:3]] == ["float", "int8"]
    assert set(lines[3]) == {"delta_is", "delta_fid"}
    assert lines[3]["delta_is"] == round(out["int8"]["is"]
                                         - out["float"]["is"], 4)
    for arm in ("float", "int8"):
        assert np.isfinite(out[arm]["is"]) and np.isfinite(out[arm]["fid"])


def test_bench_serving_via_export(capsys):
    """``--via-export``: the entry exported, saved, loaded and timed."""
    from graphical_gan_tpu_torch.tools import bench_serving
    assert bench_serving.main(["--families", "gan_inference", "--batches",
                               "2", "--depth", "1", "--rounds", "1",
                               "--via-export", "--device", "cpu", "--dim",
                               "4"]) == 0
    (rec,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rec["path"] == "export" and rec["latency_ms"] > 0
