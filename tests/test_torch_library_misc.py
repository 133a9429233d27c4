"""The small library functions no entry script uses, against the JAX
package on the CPU: ``ops/layout.py: nchw_to_nhwc, nhwc_to_nchw``,
``core/config.py: print_model_settings(_dict)``, ``data/synthetic.py:
videos_unit``, ``data/ondevice.py: epoch_batches_ondevice`` (one epoch
without replacement, the remainder dropped, one permutation for every
leaf) and ``train/checkpoint.py: params_from_jax`` over the new
parameter names (``.g``, ``cond_batchnorm``'s per-label rows, minibatch
discrimination's 3-D ``.W``): the JAX init's arrays, unchanged.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import config as jax_config
from graphical_gan_tpu.core import registry
from graphical_gan_tpu.data import synthetic as jax_synthetic
from graphical_gan_tpu.ops import layout as jax_layout
from graphical_gan_tpu.ops import norm as jnorm
from graphical_gan_tpu.ops import special as jspecial
from graphical_gan_tpu_torch.core import config
from graphical_gan_tpu_torch.data import ondevice, synthetic
from graphical_gan_tpu_torch.ops import layout
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax


def test_layout_transposes_equal_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    for ours, theirs in ((layout.nchw_to_nhwc, jax_layout.nchw_to_nhwc),
                         (layout.nhwc_to_nchw, jax_layout.nhwc_to_nchw)):
        got = ours(torch.from_numpy(x))
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(theirs(jnp.asarray(x))))
    np.testing.assert_array_equal(
        layout.nhwc_to_nchw(layout.nchw_to_nhwc(torch.from_numpy(x))).numpy(),
        x)


def test_print_model_settings_equal_jax(tmp_path, capsys):
    ns = {"DIM": 64, "BATCH_SIZE": 50, "T": 1, "lower": 2, "MODE": "ali",
          "SETTINGS": {}, "LR": 1e-4}
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    got = config.print_model_settings(ns, str(a))
    want = jax_config.print_model_settings(ns, str(b))
    assert got == want and a.read_text() == b.read_text()
    assert "\tT:" not in got and "lower" not in got
    settings = {"b": 2, "a": [1, 2], "c": "x"}
    assert config.print_model_settings_dict(settings) == \
        jax_config.print_model_settings_dict(settings)
    assert config.print_model_settings({}) == "Uppercase local vars:"
    out = capsys.readouterr().out
    assert out.count("Settings dict:") == 2


@pytest.mark.parametrize("seed", [0, 3])
def test_videos_unit_equals_jax(seed):
    got = synthetic.videos_unit(4, 5, 12, seed)
    want = jax_synthetic.videos_unit(4, 5, 12, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,b", [(20, 6), (18, 6), (7, 7)])
def test_epoch_batches_ondevice(n, b):
    data = torch.arange(n * 3).reshape(n, 3)
    gen = torch.Generator().manual_seed(5)
    out = ondevice.epoch_batches_ondevice(data, b, gen)
    assert out.shape == (n // b, b, 3)
    rows = out.reshape(-1, 3)[:, 0] // 3
    assert len(set(rows.tolist())) == (n // b) * b  # no row twice
    # a dict of aligned arrays: one permutation for every leaf
    gen = torch.Generator().manual_seed(5)
    tree = ondevice.epoch_batches_ondevice(
        {"x": data, "y": torch.arange(n)}, b, gen)
    torch.testing.assert_close(tree["x"], out)
    torch.testing.assert_close(tree["x"][..., 0] // 3, tree["y"])
    # a new generator state, another order (the reference's reshuffle)
    again = ondevice.epoch_batches_ondevice(data, b, gen)
    assert not torch.equal(again, out)


def test_params_from_jax_carries_the_new_names():
    x = jnp.zeros((4, 3, 3, 5))

    def fn():
        jnorm.cond_batchnorm("cbn", x, jnp.zeros(4, jnp.int32), 7)
        jspecial.minibatch_layer("mb", 6, 3, 2, jnp.zeros((4, 6)))
        from graphical_gan_tpu.ops.conv import conv2d
        conv2d("c", 5, 4, 3, x, weightnorm=True)
        jspecial.ladder((jnp.zeros((2, 3)),) * 2, 3, "lad")

    _, params = registry.init(fn, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    got = params_from_jax(np_params, "cpu")
    assert set(got) == set(np_params)
    assert got["cbn.scale"].shape == (7, 5) and got["mb.W"].shape == (6, 3, 2)
    assert got["c.g"].shape == (4,) and "lad.c4" in got
    for k, v in np_params.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
