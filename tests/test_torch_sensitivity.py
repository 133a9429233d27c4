"""The port's learning check (graphical_gan_tpu_torch/tools/
sensitivity.py) on the CPU at dim 8: it prints a progress line per ladder
point and then one JSON document with the JAX tool's keys (read from the
JAX tool's source, whose run at this size takes most of a minute); its
arguments and defaults are the JAX tool's; its scoring helpers agree with
the JAX tool's on the same inputs; and ``--quantize-final`` adds the
final checkpoint's scores through the int8 serving path."""

import ast
import contextlib
import inspect
import io
import json

import numpy as np
import pytest

from graphical_gan_tpu.tools import sensitivity as jax_tool
from graphical_gan_tpu_torch.tools import sensitivity
from _torch_threads import one_thread  # noqa: F401

ARGS = ["--device", "cpu", "--dim", "8", "--n-data", "256", "--n-score",
        "200", "--checkpoints", "0,2", "--clf-steps", "5"]


def _jax_main():
    return next(n for n in ast.walk(ast.parse(inspect.getsource(jax_tool)))
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _jax_record_keys():
    """The keys of the JAX tool's document (``rec = {...}``) and of its
    ``config``."""
    rec = next(n.value for n in ast.walk(_jax_main())
               if isinstance(n, ast.Assign) and getattr(
                   n.targets[0], "id", None) == "rec")
    config = next(v for k, v in zip(rec.keys, rec.values)
                  if isinstance(k, ast.Constant) and k.value == "config")
    return _dict_keys(rec), _dict_keys(config)


def _jax_arguments():
    """{dest: default} of the JAX tool's ``add_argument`` calls."""
    out = {}
    for n in ast.walk(_jax_main()):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") \
                == "add_argument":
            dest = n.args[0].value.lstrip("-").replace("-", "_")
            default = [ast.literal_eval(k.value) for k in n.keywords
                       if k.arg == "default"]
            store_true = any(k.arg == "action" and k.value.value
                             == "store_true" for k in n.keywords)
            out[dest] = default[0] if default else (
                False if store_true else None)
    return out


@pytest.fixture(scope="module")
def printed():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        doc = sensitivity.main(ARGS)
    return doc, buf.getvalue().splitlines()


def test_prints_progress_lines_then_one_document(printed):
    doc, lines = printed
    assert [json.loads(ln)["progress"]["iter"] for ln in lines[:-1]] == [0, 2]
    assert json.loads(lines[-1]) == doc


def test_the_document_has_the_jax_tool_s_keys(printed):
    doc, _ = printed
    keys, config_keys = _jax_record_keys()
    assert keys <= set(doc) and config_keys == set(doc["config"])
    assert set(doc["anchors"]) == {"heldout_real", "uniform_noise"}
    for entry in list(doc["anchors"].values()) + doc["curve"]:
        assert {"is_mean", "is_std", "fid"} <= set(entry)
        assert all(np.isfinite(entry[k]) for k in ("is_mean", "is_std",
                                                   "fid"))
    assert [e["iter"] for e in doc["curve"]] == [0, 2]
    assert doc["config"]["dim"] == 8 and doc["n_score"] == 200
    assert 0.0 <= doc["classifier_heldout_accuracy"] <= 1.0


def test_the_arguments_are_the_jax_tool_s():
    want = _jax_arguments()
    got = vars(sensitivity.parse_args([]))
    assert set(want) <= set(got)
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


def test_scoring_helpers_are_the_jax_tool_s():
    flat = np.random.default_rng(0).integers(0, 256, (30, 48))
    np.testing.assert_array_equal(sensitivity._to_hwc(flat, 3, 4, 4),
                                  jax_tool._to_hwc(flat, 3, 4, 4))
    imgs = np.random.default_rng(1).random((40, 4, 4, 3)) * 255
    w = np.random.default_rng(2).normal(size=(48, 6))

    def feature_fn(x):
        return np.tanh(x.reshape(len(x), -1) / 255.0 @ w)

    def prob_fn(x):
        e = np.exp(feature_fn(x) * 3)
        return e / e.sum(axis=1, keepdims=True)

    from graphical_gan_tpu_torch.metrics.fid import gaussian_stats
    mu, sigma = gaussian_stats(feature_fn(imgs[::-1] * 0.9))
    assert sensitivity._score(imgs, feature_fn, prob_fn, mu, sigma) == \
        jax_tool._score(imgs, feature_fn, prob_fn, mu, sigma)


def test_draw_gan_samples_gives_hwc_images_in_range():
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    model = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp",
                                                     dim=8))
    params = model.init(0, "cpu")
    out = sensitivity.draw_gan_samples(model, params, 150, batch=100)
    assert len(out) == 150 and out[0].shape == (32, 32, 3)
    arr = np.asarray(out)
    assert arr.min() >= 0.0 and arr.max() <= 255.0
    again = sensitivity.draw_gan_samples(model, params, 150, batch=100)
    np.testing.assert_array_equal(np.asarray(again), arr)


def test_quantize_final_is_refused(capsys):
    """(The name is from the slice that refused the flag.) Since int8
    serving is ported, ``--quantize-final`` scores the final checkpoint
    through the int8 path: a ``final_int8`` line before the document and
    the same entry in it, as the JAX tool prints them."""
    doc = sensitivity.main(ARGS + ["--quantize-final", "--checkpoints",
                                   "2"])
    lines = capsys.readouterr().out.splitlines()
    final = doc["final_int8"]
    assert json.loads(lines[-2]) == {"final_int8": final}
    assert final["iter"] == 2 and doc["curve"][-1]["iter"] == 2
    assert all(np.isfinite(final[k]) for k in ("is_mean", "is_std", "fid"))
    assert final != {k: v for k, v in doc["curve"][-1].items()}
