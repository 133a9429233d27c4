"""``chip_smoke.py``'s family-3 phases on the CPU: the K1 and BN shapes its
check phase holds are the ones the SSGAN model runs (spies on the two
kernel wrappers during both losses of every video D, at dim 4, B 2, LEN 3
and 4), its batch list comes from the code's constants, the parity inputs
index per leaf, and the learning check's bound and grid check refuse what
they should.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from graphical_gan_tpu_torch.core.config import ssgan_defaults  # noqa: E402
from graphical_gan_tpu_torch.models.ssgan import SSGanModel  # noqa: E402


@pytest.fixture
def kernel_calls(monkeypatch):
    """(K1 calls as (x shape, Cout, k, stride, padding, act), BN calls as
    (R, C)) made through the model's ops."""
    from graphical_gan_tpu_torch.ops import conv, norm
    seen = {"conv": set(), "bn": set()}
    k1, bn = conv.conv2d_bias_act, norm.fused_batchnorm_act

    def k1_spy(x, w, bias, stride, padding, act):
        seen["conv"].add((tuple(x.shape), w.shape[3], w.shape[0], stride,
                          padding, act))
        return k1(x, w, bias, stride, padding, act)

    def bn_spy(x, scale, offset, act, eps):
        seen["bn"].add((x.numel() // x.shape[-1], x.shape[-1]))
        return bn(x, scale, offset, act, eps)

    monkeypatch.setattr(conv, "conv2d_bias_act", k1_spy)
    monkeypatch.setattr(norm, "fused_batchnorm_act", bn_spy)
    return seen


def _losses(cfg):
    from _torch_ssgan import as_torch, raw_batch
    model = SSGanModel(cfg)
    params = model.init(0, "cpu")
    raw = as_torch(raw_batch(cfg, np.random.default_rng(0)))
    for fn in (model.gen_loss, model.disc_loss):
        fn(params, raw, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dataset,seq_len", [("moving_mnist", 4),
                                             ("chairs", 3)])
def test_checked_shapes_are_the_model_s(kernel_calls, dataset, seq_len):
    kw = dict(dim=4, dim_op=16, batch_size=2, seq_len=seq_len, bn=True)
    for mode, ali_mode in (("local_ep", "concat_x"), ("ali", "concat_x"),
                           ("ali", "concat_z"), ("ali", "3dcnn")):
        _losses(ssgan_defaults(dataset, mode, ali_mode=ali_mode, **kw))
    cfg = ssgan_defaults(dataset, **kw)
    want_conv = {(shape, cout, k, s, pad, act) for _, shape, cout, k, s, pad,
                 act in chip_smoke.ssgan_conv_shapes(cfg, 2)}
    assert kernel_calls["conv"] == want_conv
    assert kernel_calls["bn"] == {
        rc for _, rc, _ in chip_smoke.ssgan_bn_shapes(cfg, 2)}


def test_checked_batches_come_from_the_code():
    from graphical_gan_tpu_torch.runs.ssgan import hook_inputs
    b = chip_smoke.family3_batches()
    mm = ssgan_defaults("moving_mnist")
    assert b["moving_mnist"] == sorted(
        {mm.batch_size, len(hook_inputs(mm, 3)[0]),
         chip_smoke.FAMILY3_PARITY_BATCH} | set(chip_smoke.BUCKETS))
    assert b["chairs"] == [ssgan_defaults("chairs").batch_size] == [50]
    # the published frame batches: 800 and 1,550
    assert 50 * mm.seq_len == 800
    assert 50 * ssgan_defaults("chairs").seq_len == 1550


def test_parity_inputs_are_dict_batches_indexed_per_leaf():
    model = SSGanModel(ssgan_defaults("moving_mnist", dim=4, batch_size=3,
                                      seq_len=4))
    raw, noise = chip_smoke._parity_inputs(model, seed=0)
    assert raw["x"].shape == (2, 2, 3, 4, 4096)
    assert raw["y"].shape == (2, 2, 3, 10)
    assert set(noise) == {"p_z_l_0", "epsilon", "p_z_g", "p_y"}
    assert noise["p_y"].dtype == torch.int64
    one = chip_smoke._raw_at(raw, "cpu", 1, 0)
    assert torch.equal(one["y"], raw["y"][1, 0])
    chairs = SSGanModel(ssgan_defaults("chairs", dim=4, batch_size=3,
                                       seq_len=3))
    raw, noise = chip_smoke._parity_inputs(chairs, seed=0)
    assert set(raw) == {"x"} and set(noise) == {"p_z_l_0", "epsilon",
                                                "p_z_g"}
    assert float(raw["x"].max()) > 1.0  # raw pixels


@pytest.mark.parametrize("leaf,kind", [
    ("Generator.5.Biases", "ratio"),      # deconv, tanh after it
    ("Generator.Input.b", "ratio"),       # linear
    ("Extractor.2.Biases", "ratio"),      # K1 conv, no act fused
    ("Extractor.1.Biases", None),         # K1 conv, leaky fused
    ("Generator.5.Filters", None)])       # no bias
def test_bias_cancellation_witness(leaf, kind):
    """``_bias_cancellation`` sums its terms to the leaf's gradient (else
    it gives None) and gives |g| / sum |t| in (0, 1]; None where the
    layer fuses its activation or the leaf is no bias."""
    model = SSGanModel(ssgan_defaults("moving_mnist", "local_ep", dim=4,
                                      dim_op=16, batch_size=2, seq_len=3,
                                      pos_mode="gsp"))
    params = model.init(seed=1, device="cpu")
    raw, noise = chip_smoke._parity_inputs(model, seed=0)
    r = chip_smoke._bias_cancellation(
        model, params, chip_smoke._raw_at(raw, "cpu", 0, 0),
        chip_smoke._update_draws(model, noise, 0, 0), "gen", leaf)
    if kind is None:
        assert r is None
    else:
        assert r is not None and 0.0 < r <= 1.0 + 1e-12
    from graphical_gan_tpu_torch.models import ssgan
    assert ssgan.deconv2d.__name__ == "deconv2d"  # the spies are undone


@pytest.mark.parametrize("recs,ok", [
    ({0: 0.2009, 599: 0.0842, 1000: 0.1076}, False),
    ({0: 0.24, 599: 0.08, 1000: 0.06}, True),
    ({0: 0.24, 599: 0.30, 1000: 0.12}, True),
    ({0: 0.24, 599: 0.12, 1000: 0.13}, False),
    ({0: 0.24, 599: 0.02, 1000: 0.25}, False),
    ({0: 0.24, 1000: 0.06}, True),
    ({0: 0.24, 599: 0.06}, False),
    ({599: 0.08, 1000: 0.06}, False),
    ({0: 0.24, 599: 0.08, 1000: float("nan")}, False),
    ({}, False)])
def test_family3_learn_check(recs, ok):
    assert (chip_smoke.learn3_misses(recs) == []) == ok


@pytest.mark.parametrize("channels", [1, 3])
def test_ssgan_grid_check(tmp_path, channels):
    from graphical_gan_tpu_torch.runs.ssgan import _vis
    cfg = ssgan_defaults("moving_mnist", seq_len=3, channels=channels)
    x = np.random.default_rng(0).random((4, 3, cfg.output_dim),
                                        dtype=np.float32)
    _vis(cfg, str(tmp_path), x, 7, 4, "samples")
    path = str(tmp_path / "samples_7.png")
    assert chip_smoke.ssgan_grid_misses(path, 4, cfg) == []
    assert chip_smoke.ssgan_grid_misses(path, 5, cfg)
    os.unlink(str(tmp_path / "samples_7.gif"))
    assert chip_smoke.ssgan_grid_misses(path, 4, cfg)
    assert chip_smoke.ssgan_grid_misses(str(tmp_path / "none.png"), 4, cfg)
