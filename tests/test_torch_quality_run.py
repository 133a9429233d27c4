"""The port's bf16-vs-f32 quality tool (``graphical_gan_tpu_torch/tools/
quality_run.py``) against the JAX package's ``tools/quality_run.py`` on
the CPU:

- ``--device cpu --dim 8 --iters 3``: one record per dtype with the JAX
  tool's keys (``run_dtype``'s, driven here through the JAX code with the
  same training history handed in, plus ``fid_vs_train`` and
  ``hermetic_is``), finite, and the summary after both dtypes;
- ``run_dtype``'s record from a given logger history equals JAX's:
  ``disc_cost_windows`` and the throughput counted as (1+k)·B images per
  iteration over the median ``time`` from min(100, iters/2) on;
- ``_window_means`` and ``_train_images_hwc`` equal JAX's.

JAX's docstring says ``GGAN_INCEPTION_PB`` switches the tool to the frozen
head; its code never reads it, and the port follows the code.
"""

import json
import types

import numpy as np
import pytest
import torch

from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.report.plot import MetricLogger as JaxLogger
from graphical_gan_tpu.tools import quality_run as jax_qr
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.report.plot import MetricLogger
from graphical_gan_tpu_torch.tools import quality_run as qr
from _torch_threads import one_thread  # noqa: F401

ITERS = 300


def _history(logger):
    rng = np.random.default_rng(0)
    for it in range(ITERS):
        logger.plot("time", 0.05 + 0.01 * rng.random())
        logger.plot("train disc cost", -0.01 * it + rng.random())
        if it % 100 == 99:
            logger.flush()
        logger.tick()
    logger.flush()
    return logger


def _fake_trainer(logger, params, cfg):
    return types.SimpleNamespace(
        logger=logger, k=cfg.critic_iters, cfg=cfg, params=params,
        state=types.SimpleNamespace(params=params))


def _jax_record(monkeypatch):
    import jax.numpy as jnp
    from graphical_gan_tpu.runs import gan_inference as jax_gi
    cfg = jax_cfg("cifar10", "wali-gp")
    trainer = _fake_trainer(_history(JaxLogger()), {"w": jnp.ones(3)}, cfg)
    last = {"gen_cost": 1.23456, "disc_cost": -0.5}
    monkeypatch.setattr(jax_gi, "run", lambda *a, **k: (trainer, last))
    return jax_qr.run_dtype("bfloat16", ITERS, "unused", 0)[1]


def test_run_dtype_record_equals_jax(monkeypatch):
    from graphical_gan_tpu_torch.runs import gan_inference as port_gi
    want = _jax_record(monkeypatch)
    cfg = gan_inference_defaults("cifar10", "wali-gp")
    trainer = _fake_trainer(_history(MetricLogger()),
                            {"w": torch.ones(3)}, cfg)
    last = {"gen_cost": 1.23456, "disc_cost": -0.5}
    seen = {}

    def fake_run(*a, **kw):
        seen.update(kw)
        return trainer, last
    monkeypatch.setattr(port_gi, "run", fake_run)
    got = qr.run_dtype("bfloat16", ITERS, "unused", 0, device="cpu")[1]
    assert set(got) == set(want)
    for key in want:
        if key != "wall_seconds":
            assert got[key] == want[key], key
    assert got["train_throughput_img_per_sec"] == round(
        6 * 64 / np.median([trainer.logger.history("time")[k]
                            for k in range(100, ITERS)]), 1)
    assert seen["compute_dtype"] == "bfloat16" and seen["device"] == "cpu"
    assert (seen["tsne_every"], seen["inception_every"]) == (0, 0)


def test_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    want_keys = set(_jax_record(monkeypatch)) | {"fid_vs_train",
                                                  "hermetic_is"}
    recs = qr.main(["--device", "cpu", "--dim", "8", "--iters", "3",
                    "--n-metric-samples", "100", "--outdir",
                    str(tmp_path)])
    assert [r["dtype"] for r in recs] == ["bfloat16", "float32"]
    out = capsys.readouterr().out
    for rec in recs:
        assert set(rec) == want_keys
        assert rec["params_finite"] and rec["losses_finite"]
        assert rec["iters"] == 3 and len(rec["disc_cost_windows"]) == 3
        assert np.isfinite(rec["fid_vs_train"])
        assert np.isfinite(rec["hermetic_is"]).all()
        assert json.dumps(rec) in out
    assert "summary: bfloat16 vs float32" in out


@pytest.mark.parametrize("n", [0, 3, 10, 37])
def test_window_means_equal_jax(n):
    hist = {i * 7: float(np.sin(i)) for i in range(n)}
    assert qr._window_means(hist) == jax_qr._window_means(hist)


@pytest.mark.parametrize("dataset", ["cifar10", "mnist"])
def test_train_images_hwc_equal_jax(dataset):
    cfg = gan_inference_defaults(dataset, "ali")
    jcfg = jax_cfg(dataset, "ali")
    d = int(np.prod(cfg.data.image_hw)) * cfg.data.channels
    rows = np.random.default_rng(1).integers(0, 256, (12, d)).astype(
        np.uint8 if dataset == "cifar10" else np.float32)
    np.testing.assert_array_equal(qr._train_images_hwc(cfg, rows, 10),
                                  jax_qr._train_images_hwc(jcfg, rows, 10))
