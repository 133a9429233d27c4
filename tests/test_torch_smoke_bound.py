"""chip_smoke.py's checks that run on the CPU. The operation count behind
its bound for the fused conv: only the taps that land inside the input are
work the function needs, checked against a count made by convolving ones
over the zero-padded input, at the serving sizes and at odd sizes, strides
and kernels; the BN kernels' byte bounds. The learn phase's bounds, which
must refuse a flat curve, a falling IS, a rising FID and anchors or an
accuracy out of bounds; the eval phase's grid check (the IHDR size of each
PNG) and logfile check; the classifier shapes it checks the kernels at,
which must be the ones the classifier runs; and the batch sizes it checks
them at, which must be the ones the quality hook and tools/sensitivity.py
run the classifier and G's sampler at."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads  # noqa: E402


@pytest.mark.parametrize("n,k,s", [(32, 5, 2), (16, 5, 2), (8, 5, 2),
                                   (7, 5, 2), (9, 3, 1), (8, 1, 1)])
def test_conv_valid_taps_counts_taps_inside_the_input(n, k, s):
    lo, hi = same_pads(n, k, s)
    x = F.pad(torch.ones(1, 1, n), (lo, hi))
    taps = F.conv1d(x, torch.ones(1, 1, k), stride=s)
    assert taps.shape[-1] == -(-n // s)
    assert chip_smoke.conv_valid_taps(n, k, s, lo) == int(taps.sum())


def test_serving_shapes_need_fewer_taps_than_the_full_window():
    # E.1, E.2, E.3: 32 -> 16, 16 -> 8, 8 -> 4 at k5 s2, pads (1, 2)
    share = {n: (chip_smoke.conv_valid_taps(n, 5, 2, 1) / (5 * n // 2)) ** 2
             for n in (32, 16, 8)}
    assert share == pytest.approx({32: 0.92640625, 16: 0.855625,
                                   8: 0.7225})


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,name,rc", [
    (b, name, rc) for b in (64, 256)
    for name, rc, _ in chip_smoke.bn_shapes(b)],
    ids=lambda v: str(v) if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_bn_backward_bound_reads_g_and_x_once_and_writes_dx(b, name, rc,
                                                            itemsize):
    """K2c+K2d's bound: each tensor the function reads (g, x, and mean,
    inv, scale and offset in f32) read once and each it writes (dx, and
    red = [2, C] f32) written once, over the card's memory rate; the
    operations (24 f32 per element) bound it at none of the BN shapes."""
    r, c = rc
    dtype = {4: torch.float32, 2: torch.bfloat16}[itemsize]

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    reads = [meta((r, c), dtype), meta((r, c), dtype)] + [
        meta((c,), torch.float32) for _ in range(4)]
    writes = [meta((r, c), dtype), meta((2, c), torch.float32)]
    nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
    ms, by = chip_smoke.bn_bwd_bound(r, c, itemsize)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_S * 1e3,
                               rel=1e-12)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,name,rc", [
    (b, name, rc) for b in (64, 256)
    for name, rc, _ in chip_smoke.bn_shapes(b)],
    ids=lambda v: str(v) if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_bn_stats_bound_reads_x_once_and_writes_the_statistics(b, name, rc,
                                                               itemsize):
    """K2a's bound: the tensor the function reads (x) read once and each it
    writes (mean, var and inv, f32 [C]) written once, over the card's
    memory rate; the operations (3 f32 per element) bound it at none of
    the BN shapes."""
    r, c = rc
    dtype = {4: torch.float32, 2: torch.bfloat16}[itemsize]

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    reads = [meta((r, c), dtype)]
    writes = [meta((c,), torch.float32) for _ in range(3)]
    nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
    ms, by = chip_smoke.bn_stats_bound(r, c, itemsize)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_S * 1e3,
                               rel=1e-12)


# -- the learn and eval phases' checks ------------------------------------------

def _learn_doc(**change):
    """A sensitivity document that passes (the shape of the card's run)."""
    doc = {"classifier_heldout_accuracy": 1.0,
           "anchors": {"heldout_real": {"is_mean": 9.89, "is_std": 0.05,
                                        "fid": 0.03},
                       "uniform_noise": {"is_mean": 1.23, "is_std": 0.0,
                                         "fid": 39.2}},
           "curve": [{"iter": 0, "is_mean": 1.21, "is_std": 0.0,
                      "fid": 39.6},
                     {"iter": 500, "is_mean": 1.79, "is_std": 0.01,
                      "fid": 30.7}]}
    for path, value in change.items():
        node = doc
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[int(k)] if k.isdigit() else node[k]
        node[int(keys[-1]) if keys[-1].isdigit() else keys[-1]] = value
    return doc


def test_learn_check_passes_a_curve_that_learns():
    assert chip_smoke.learn_misses(_learn_doc()) == []


@pytest.mark.parametrize("change,word", [
    ({"curve.1.is_mean": 1.21, "curve.1.fid": 39.6}, "IS did not rise"),
    ({"curve.1.is_mean": 1.1}, "IS did not rise"),
    ({"curve.1.fid": 41.0}, "FID did not fall"),
    ({"anchors.uniform_noise.is_mean": 2.01}, "uniform-noise IS"),
    ({"anchors.heldout_real.is_mean": 7.9}, "held-out real IS"),
    ({"classifier_heldout_accuracy": 0.94}, "accuracy"),
    ({"curve.1.is_mean": float("nan")}, "IS did not rise"),
], ids=["flat curve", "falling IS", "rising FID", "noise anchor above 2",
        "real anchor below 8", "accuracy below 0.95", "nan IS"])
def test_learn_check_refuses(change, word):
    misses = chip_smoke.learn_misses(_learn_doc(**change))
    assert misses and any(word in m for m in misses)


def test_learn_check_refuses_a_one_point_curve():
    doc = _learn_doc()
    doc["curve"] = doc["curve"][:1]
    assert chip_smoke.learn_misses(doc) == ["a curve of 1 points"]


@pytest.mark.parametrize("n,hw,c", [(128, (32, 32), 3), (100, (28, 28), 1),
                                    (128, (64, 64), 3)])
def test_grid_check_passes_the_writer_s_png(tmp_path, n, hw, c):
    from graphical_gan_tpu_torch.report.save_images import save_images
    path = str(tmp_path / "g.png")
    x = np.random.default_rng(0).random((n, c, *hw) if c > 1 else (n, *hw))
    save_images(x, path)
    assert chip_smoke.grid_misses(path, n, hw, c) == []


@pytest.mark.parametrize("write_n,write_c", [(64, 3), (128, 1), (126, 3)],
                         ids=["fewer images", "gray for rgb",
                              "another grid"])
def test_grid_check_refuses_a_png_of_the_wrong_size(tmp_path, write_n,
                                                    write_c):
    from graphical_gan_tpu_torch.report.save_images import save_images
    path = str(tmp_path / "g.png")
    shape = (write_n, write_c, 32, 32) if write_c > 1 else (write_n, 32, 32)
    save_images(np.zeros(shape), path)
    misses = chip_smoke.grid_misses(path, 128, (32, 32), 3)
    assert misses and "not" in misses[0]


def test_grid_check_refuses_a_missing_or_broken_file(tmp_path):
    assert chip_smoke.grid_misses(str(tmp_path / "none.png"), 4, (8, 8), 1)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all, long enough to hold a header")
    assert "not a PNG" in chip_smoke.grid_misses(str(bad), 4, (8, 8), 1)[0]


EVAL_LOG = ("iter 98\ttime\t0.1\ttrain disc cost\t-3.0\n"
            "iter 99\ttime\t0.1\ttrain disc cost\t-3.1\tdev gen cost\t2.5\n"
            "iter 100\tmetric classifier heldout acc\t1.0\tinception score"
            "\t1.4\tinception score std\t0.01\tfid\t35.0\n")


def test_eval_log_check_passes_a_full_log():
    assert chip_smoke.eval_log_misses(EVAL_LOG, 99) == []


@pytest.mark.parametrize("edit,word", [
    (("\tdev gen cost\t2.5", ""), "dev cost"),
    (("dev gen cost\t2.5", "dev gen cost\tnan"), "dev cost"),
    (("\tfid\t35.0", ""), "'fid'"),
    (("inception score\t1.4", "inception score\tinf"), "'inception score'"),
    (("iter 100\tmetric", "tsne skipped: x\niter 100\tmetric"), "tsne"),
], ids=["no dev cost", "nan dev cost", "no fid", "inf IS", "tsne line"])
def test_eval_log_check_refuses(edit, word):
    misses = chip_smoke.eval_log_misses(EVAL_LOG.replace(*edit), 99)
    assert any(word in m for m in misses)


@pytest.mark.parametrize("hw,cin,rows", [(32, 3, (64, 16)),
                                         (28, 1, (49, 16))])
def test_classifier_shapes_are_the_classifier_s(hw, cin, rows):
    """chip_smoke's classifier shapes are what metrics/classifier.py runs:
    the conv inputs and BN rows of a forward at B = 5 (dim 32)."""
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.ops.kernels import fused_conv, fused_norm
    seen = {"conv": [], "bn": []}
    conv_fn, bn_fn = fused_conv.conv2d_bias_act, fused_norm.fused_batchnorm_act

    def conv_spy(x, w, *a, **k):
        seen["conv"].append((tuple(x.shape), w.shape[3]))
        return conv_fn(x, w, *a, **k)

    def bn_spy(x, *a, **k):
        seen["bn"].append(tuple(x.reshape(-1, x.shape[-1]).shape))
        return bn_fn(x, *a, **k)

    import graphical_gan_tpu_torch.ops.conv as conv_mod
    import graphical_gan_tpu_torch.ops.norm as norm_mod
    clf = MetricClassifier((hw, hw), cin, dim=32, device="cpu")
    x = np.zeros((5, cin * hw * hw), np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv_mod, "conv2d_bias_act", conv_spy)
        mp.setattr(norm_mod, "fused_batchnorm_act", bn_spy)
        clf.forward(clf.init(0), x)
    conv, bn = chip_smoke.classifier_shapes(5, hw, cin)
    assert seen["conv"] == [(shape, cout) for _, shape, cout, _ in conv]
    assert seen["bn"] == [rc for _, rc, _ in bn]
    assert [rc[0] // 5 for _, rc, _ in bn] == list(rows)


@pytest.fixture
def clf_batches(monkeypatch):
    """The batch sizes the metric classifier's trunk and G's sampler see."""
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    seen = {"clf": set(), "G": set()}
    trunk, sample = MetricClassifier.trunk, GanInferenceModel.sample

    def trunk_spy(self, params, x):
        seen["clf"].add(len(x))
        return trunk(self, params, x)

    def sample_spy(self, params, noise):
        seen["G"].add(noise.shape[0])
        return sample(self, params, noise)

    monkeypatch.setattr(MetricClassifier, "trunk", trunk_spy)
    monkeypatch.setattr(GanInferenceModel, "sample", sample_spy)
    return seen


def test_checked_batches_are_the_quality_hook_s(clf_batches):
    """The quality hook (eval phase) runs the classifier at exactly
    quality_hook_batches(...) and G at generator_sample_batches()."""
    import types
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu_torch.runs import gan_inference as port_run
    cfg = gan_inference_defaults("cifar10", "wali-gp", dim=8, batch_size=4)
    model = GanInferenceModel(cfg)
    _, _, pools_ = port_run._structured_pool(cfg, n_train=300, n_eval=40)
    plots = {}
    trainer = types.SimpleNamespace(
        device=torch.device("cpu"), params=model.init(0, "cpu"),
        logger=types.SimpleNamespace(plot=plots.__setitem__),
        eval_generator=lambda salt, it: torch.Generator().manual_seed(salt))
    port_run.make_structured_quality_hook(model, pools_, n_score=250,
                                          clf_steps=2)(trainer, 9)
    assert np.isfinite(plots["fid"])
    assert clf_batches["clf"] == chip_smoke.quality_hook_batches(250, 300, 40)
    assert clf_batches["G"] <= set(chip_smoke.generator_sample_batches())


def test_checked_batches_are_the_sensitivity_tool_s(clf_batches, capsys):
    """tools/sensitivity.py (learn phase) runs the classifier at exactly
    sensitivity_batches(argv) and G at generator_sample_batches()."""
    from graphical_gan_tpu_torch.tools import sensitivity
    argv = ["--n-data", "64", "--n-score", "150", "--checkpoints", "0",
            "--clf-steps", "2", "--dim", "8"]
    sensitivity.main(argv + ["--device", "cpu"])
    want = chip_smoke.sensitivity_batches(argv)
    assert clf_batches["clf"] == want == {256, 512, 64, 150, 100, 50}
    assert clf_batches["G"] <= set(chip_smoke.generator_sample_batches())


def test_checked_batches_cover_the_eval_and_learn_phases():
    """The check phase's batch lists are the eval phase's quality hook at
    its defaults, the learn phase's and the tool's defaults, and G's grid
    at cifar10's n_vis."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    got = set(chip_smoke.classifier_batches())
    assert chip_smoke.quality_hook_batches(10000, 20000, 2000) <= got
    assert chip_smoke.sensitivity_batches(chip_smoke.LEARN_ARGS) <= got
    assert {512, 464, 96, 4096, 5000, 10000} <= got
    assert gan_inference_defaults("cifar10", "wali-gp").n_vis in \
        chip_smoke.generator_sample_batches()
