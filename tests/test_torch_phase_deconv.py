"""The port's phase-decomposed stride-2 transposed conv
(``graphical_gan_tpu_torch/ops/phase_deconv.py``: one stride-1 K1 conv to
4·O channels with explicit window pads, then a depth-to-space) against the
JAX package's ``ops/phase_deconv.py`` and ``lax.conv_transpose``, on the
CPU (K1's plain version), from the same numpy inputs:

- the tap plan equals JAX's for k in {3, 4, 5};
- values for k in {3, 4, 5} x (h, w) in {(4, 4), (7, 5), (8, 8)} at
  rtol = atol = 2e-5 (k = 3's window pads are (1, 0), which neither SAME
  nor VALID gives);
- gradients with respect to x and the filter at 3e-5;
- ``deconv2d`` with the gate on and off in both packages at 2e-5, and the
  gate's parsing (off by default);
- the slice as a whole: the cifar10 generator (dim 8, B 4, f32) with
  ``GGAN_PHASE_DECONV=1`` in both packages, from the same parameters and
  codes, at rtol 1e-4 over the image.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu.ops import conv as jax_conv
from graphical_gan_tpu.ops import phase_deconv as jax_phase
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.ops import conv as port_conv
from graphical_gan_tpu_torch.ops import phase_deconv
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
from _torch_threads import one_thread  # noqa: F401

_DN2D = ("NHWC", "HWIO", "NHWC")


def _lax(x, w):
    return lax.conv_transpose(x, w, strides=(2, 2), padding="SAME",
                              dimension_numbers=_DN2D, transpose_kernel=True)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_phase_plan_equals_jax(k):
    assert phase_deconv._phase_plan(k) == jax_phase._phase_plan(k)


@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("h,w_sp", [(4, 4), (7, 5), (8, 8)])
def test_conv_transpose_phase_matches_jax(k, h, w_sp):
    rng = np.random.RandomState(k * 100 + h)
    ci, co = 6, 7
    x = rng.randn(2, h, w_sp, ci).astype(np.float32)
    wk = rng.randn(k, k, co, ci).astype(np.float32)
    got = phase_deconv.conv_transpose_phase(torch.from_numpy(x),
                                            torch.from_numpy(wk)).numpy()
    assert got.shape == (2, 2 * h, 2 * w_sp, co)
    for want in (jax_phase.conv_transpose_phase(jnp.asarray(x),
                                                jnp.asarray(wk)),
                 _lax(jnp.asarray(x), jnp.asarray(wk))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_gradients_match_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 8, 7, 5).astype(np.float32)
    wk = rng.randn(k, k, 4, 5).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    cot = rng.randn(2, 16, 14, 4).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(_lax(a, b) * cot),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, wk,
                                                                 bias)]
    out = phase_deconv.conv_transpose_phase(*leaves)
    tx, tw, tb = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                     leaves)
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(gw), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(tb.numpy(), cot.sum((0, 1, 2)), rtol=3e-5,
                               atol=3e-5)


def test_deconv2d_under_the_gate_matches_jax(monkeypatch):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 8, 12).astype(np.float32)
    jx = jnp.asarray(x)

    def layer():
        return jax_conv.deconv2d("D", 12, 9, 5, jx)
    _, jp = registry.init(layer, jax.random.PRNGKey(7))
    # a bias that is not zero, so that the epilogue's add is checked
    jp = dict(jp, **{"D.Biases": jnp.asarray(rng.randn(9), jnp.float32)})
    tp = params_from_jax({n: np.asarray(v) for n, v in jp.items()}, "cpu")
    outs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GGAN_PHASE_DECONV", flag)
        outs["jax", flag] = np.asarray(registry.apply(layer, jp, None))
        outs["port", flag] = port_conv.deconv2d(tp, "D",
                                                torch.from_numpy(x)).numpy()
    for key, got in outs.items():
        np.testing.assert_allclose(got, outs["jax", "0"], rtol=2e-5,
                                   atol=2e-5, err_msg=str(key))


def test_gate_is_off_by_default(monkeypatch):
    monkeypatch.delenv("GGAN_PHASE_DECONV", raising=False)
    assert not phase_deconv.use_phase_deconv()
    for value, on in (("0", False), ("false", False), ("", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("GGAN_PHASE_DECONV", value)
        assert phase_deconv.use_phase_deconv() is on
        assert jax_phase.use_phase_deconv() is on


def test_cifar10_generator_with_the_gate_matches_jax(monkeypatch):
    """cifar10's G (dim 8, B 4, f32): its three deconvs (G.2, G.3, G.5) on
    the phase route in both packages."""
    monkeypatch.setenv("GGAN_PHASE_DECONV", "1")
    kw = dict(dim=8, batch_size=4)
    jm = JaxM(jax_cfg("cifar10", "wali-gp", **kw))
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp",
                                                  **kw))
    noise = np.random.default_rng(3).standard_normal(
        (4, tm.cfg.dim_latent)).astype(np.float32)
    jn = jnp.asarray(noise)
    _, jp = registry.init(lambda: jm.sample(jn), jax.random.PRNGKey(0))
    want = np.asarray(jax.jit(lambda p: registry.apply(
        lambda: jm.sample(jn), p, jax.random.PRNGKey(0)))(jp))
    tp = params_from_jax({n: np.asarray(v) for n, v in jp.items()}, "cpu")
    calls = []
    orig = phase_deconv.conv_transpose_phase
    monkeypatch.setattr(port_conv, "conv_transpose_phase",
                        lambda *a: calls.append(1) or orig(*a))
    got = tm.sample(tp, torch.from_numpy(noise)).numpy()
    assert len(calls) == 3
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        np.abs(want).max()))
