"""The port's metric logger (``graphical_gan_tpu_torch/report/plot.py``)
against the JAX package's ``MetricLogger`` on the same calls: the flush
lines, ``history`` of every flushed value, the curve images ``flush``
renders into ``outf`` (``importorskip("matplotlib")``, as JAX's
tests/test_trainer.py does), and the Trainer's ``render_curves``: each
flush renders one ``<name>.jpg`` per metric into the run directory, with
``GGAN_RENDER_CURVES`` as the default (tests/conftest.py sets it to 0).
"""

import os

import numpy as np
import pytest

from graphical_gan_tpu.report.plot import MetricLogger as JaxLogger
from graphical_gan_tpu_torch.report.plot import MetricLogger
from _torch_threads import one_thread  # noqa: F401
from _torch_trainer import make_trainer


def _drive(logger, tmp, render):
    lines = []
    for it in range(7):
        logger.plot("time", 0.5 + it)
        if it % 2:
            logger.plot("train disc cost", np.float32(1.0 / (it + 1)))
        if it == 4:
            logger.plot_at("dev gen cost", 3.25, 2)
        if it in (2, 5):
            lines.append(logger.flush(str(tmp), os.path.join(
                str(tmp), "log.txt"), render=render))
        logger.tick()
    return lines


def test_lines_and_history_equal_jax(tmp_path):
    got, want = MetricLogger(), JaxLogger()
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert _drive(got, tmp_path / "a", False) == \
        _drive(want, tmp_path / "b", False)
    assert got.iteration == want.iteration == 7
    for name in ("time", "train disc cost", "dev gen cost", "missing"):
        assert got.history(name) == want.history(name)
    assert got.pending and want.pending  # iteration 6's values
    assert (tmp_path / "a" / "log.txt").read_text() == \
        (tmp_path / "b" / "log.txt").read_text()
    assert not [f for f in os.listdir(tmp_path / "a")
                if f.endswith(".jpg")]


def test_flush_renders_one_curve_per_metric(tmp_path):
    pytest.importorskip("matplotlib")
    _drive(MetricLogger(), tmp_path, True)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".jpg")) \
        == ["dev_gen_cost.jpg", "time.jpg", "train_disc_cost.jpg"]
    with open(tmp_path / "time.jpg", "rb") as f:
        assert f.read(2) == b"\xff\xd8"  # a JPEG


def test_trainer_renders_metric_curves(tmp_path):
    """render_curves=True (the production default) wins over the tests'
    GGAN_RENDER_CURVES=0 (JAX tests/test_trainer.py:45-57)."""
    pytest.importorskip("matplotlib")
    tr = make_trainer(tmp_path, render_curves=True)
    tr.train(3)
    assert os.path.isfile(tmp_path / "train_disc_cost.jpg")
    assert os.path.isfile(tmp_path / "time.jpg")
    assert set(tr.logger.history("time")) == {0, 1, 2}
    assert make_trainer(tmp_path / "b").render_curves is False


def test_render_curves_defaults_to_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("GGAN_RENDER_CURVES", "1")
    assert make_trainer(tmp_path / "a").render_curves is True
    monkeypatch.setenv("GGAN_RENDER_CURVES", "0")
    assert make_trainer(tmp_path / "b").render_curves is False
    monkeypatch.delenv("GGAN_RENDER_CURVES")
    assert make_trainer(tmp_path / "c").render_curves is True
    tr = make_trainer(tmp_path / "d", render_curves=False)
    tr.train(2)
    assert not [f for f in os.listdir(tmp_path / "d") if f.endswith(".jpg")]
    assert sorted(tr.logger.history("train disc cost")) == [0, 1]
