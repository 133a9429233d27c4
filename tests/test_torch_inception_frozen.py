"""The port's frozen Inception-2015 classifier (graphical_gan_tpu_torch/
metrics/inception_frozen.py) against the JAX package's on the CPU, and the
two entries that pick it: ``metrics/inception.py: default_is_classifier``
and ``tools/score_samples.py --classifier frozen``.

- tests/test_inception_frozen.py: build_fixture (the mini inception that
  JAX's tests hold to a TensorFlow session): probabilities within 1e-6
  absolute of JAX's, pool_3 within 1e-5 relative L2;
- chip_smoke.py's v3 graph cut after the stem (the 2015 input pipeline,
  the legacy resize to 299, five convs with the global-norm BN, the
  pools): probabilities within 1e-6 of JAX's at 32x32 inputs;
- with ``GGAN_INCEPTION_PB`` naming a graph, ``default_is_classifier``
  returns the frozen head, and ``score_samples --classifier frozen``
  scores with it and records ``frozen-inception-2015:<path>``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from graphical_gan_tpu.metrics import inception_frozen as jax_frozen
from graphical_gan_tpu_torch.metrics import inception
from graphical_gan_tpu_torch.metrics import inception_frozen as frozen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PROB_ATOL = 1e-6


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("hw", [(8, 8), (9, 11)])
def test_mini_fixture_matches_jax(hw):
    pytest.importorskip("tensorflow")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_inception_frozen import build_fixture
    data = build_fixture().SerializeToString()
    x = np.random.RandomState(2).rand(6, *hw, 3).astype(np.float32) * 255
    want = jax_frozen.FrozenInceptionClassifier(data)(x)
    clf = frozen.FrozenInceptionClassifier(data, device="cpu")
    got = clf(x)
    assert got.shape == want.shape == (6, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    jint = jax_frozen.GraphInterpreter(clf.interp.nodes.values())
    want_pool = np.asarray(jint.make_fn("ExpandDims", ["pool_3"])(
        jint.consts, x)[0])
    got_pool = clf.pool3_and_probs(torch.from_numpy(x))[0].numpy()
    assert _rel_l2(got_pool, want_pool) < 1e-5


@pytest.fixture(scope="module")
def stem_pb(tmp_path_factory):
    """chip_smoke.py's v3 graph cut after the stem, as a .pb file."""
    path = tmp_path_factory.mktemp("pb") / "classify_image_graph_def.pb"
    path.write_bytes(chip_smoke.inception_v3_2015_graphdef(stages=1))
    return str(path)


def test_stem_graph_matches_jax(stem_pb):
    x = np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32) * 255
    want = jax_frozen.FrozenInceptionClassifier(stem_pb)(x)
    got = frozen.FrozenInceptionClassifier(stem_pb, device="cpu")(x)
    assert got.shape == want.shape == (3, 1008)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_default_is_classifier_takes_the_frozen_graph(stem_pb, monkeypatch):
    monkeypatch.setenv("GGAN_INCEPTION_PB", stem_pb)
    clf = inception.default_is_classifier("cpu")
    assert isinstance(clf, frozen.FrozenInceptionClassifier)
    assert clf.device.type == "cpu"
    x = np.random.RandomState(6).rand(2, 32, 32, 3).astype(np.float32) * 255
    np.testing.assert_allclose(
        clf(x), jax_frozen.FrozenInceptionClassifier(stem_pb)(x),
        rtol=0, atol=PROB_ATOL)


def test_the_frozen_classifier_needs_a_card_unless_asked_for_the_cpu(
        stem_pb, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frozen.FrozenInceptionClassifier(stem_pb)
    monkeypatch.setenv("GGAN_INCEPTION_PB", stem_pb)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inception.default_is_classifier()


def test_score_samples_with_the_frozen_graph(stem_pb, tmp_path, capsys):
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    from graphical_gan_tpu_torch.tools import score_samples
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    model = GanInferenceModel(gan_inference_defaults("cifar10", "ali",
                                                     dim=8))
    ckpt = save_params(str(tmp_path / "ckpt_0.npz"), model.init(0, "cpu"),
                       {"iteration": 0})
    prob_fn, ident = score_samples.make_classifier(
        "frozen", stem_pb, (32, 32), 3, device="cpu")
    assert ident == f"frozen-inception-2015:{stem_pb}"
    assert isinstance(prob_fn, frozen.FrozenInceptionClassifier)
    rec = score_samples.main([
        "--ckpt", ckpt, "--dataset", "cifar10", "--mode", "ali", "--dim",
        "8", "--n-samples", "20", "--splits", "2", "--classifier",
        "frozen", "--classifier-ckpt", stem_pb, "--device", "cpu"])
    assert rec["classifier"] == ident and rec["n_samples"] == 20
    assert np.isfinite(rec["inception_score"]) \
        and rec["inception_score"] >= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
