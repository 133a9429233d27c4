"""The port's quantized samplers (``ops/quant.py``, ``serve/quantize.py``)
against the JAX package's on the CPU.

- Calibration: on the same numpy latents, JAX's sampler run eagerly under
  its ``quant.calibrating`` and the port's under its own record the same
  layer names, with absmax values within 1e-5 relative (gan_inference
  mnist, gmgan mnist, ssgan moving-MNIST with its latent chain).
- The whole quantized sampler against JAX's, both given JAX's scales (a
  JAX ``act_scales.json`` loads in the port as it is). Per-layer exactness
  (tests/test_torch_quant_layers.py) does not carry end to end: the float
  layers between the int8 products differ by f32 roundings between the two
  frameworks, and a value within that of a rounding boundary flips by one
  int8 step, moving later elements by about s_x * s_w * |w| (1e-3 here).
  Measured at these seeds and sizes: no flip in any of the samplers,
  and the largest difference 1.8e-7 (f32 roundings of outputs in [-1, 1]);
  so every element is held to 1e-6, under a tenth of one int8 step's
  effect, and any flip fails the test.
- Outside a context the float sampler and a training step run as they did
  before the intercepts existed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graphical_gan_tpu.ops import quant as jq
from graphical_gan_tpu.serve.export import make_sampler as jax_make_sampler
from graphical_gan_tpu_torch.ops import quant as tq
from graphical_gan_tpu_torch.serve.export import make_sampler
from graphical_gan_tpu_torch.serve.quantize import (
    calibrate, prior_inputs, quantized_entry)

import _torch_family1 as fam1
import _torch_gmgan as fam2
import _torch_ssgan as fam3
from _torch_threads import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
E2E_ATOL = 1e-6
CALIB_RTOL = 1e-5


def _case(name):
    """(family, jax model, port model, jax params, port params, numpy
    inputs, port draws) at small widths."""
    rng = np.random.default_rng(1)
    if name.startswith("gan"):
        dataset = name.split("-")[1]
        jm, tm, jp, tp = fam1.models(dataset, "ali")
        cfg = jm.cfg
        inputs = (rng.standard_normal((8, cfg.dim_latent), np.float32),)
        return "gan_inference", jm, tm, jp, tp, inputs, None
    if name == "gmgan":
        jm, tm, jp, tp = fam2.models("mnist", "local_ep")
        cfg = jm.cfg
        inputs = (np.eye(cfg.n_coms, dtype=np.float32)[
            rng.integers(0, cfg.n_coms, 8)],
            rng.standard_normal((8, cfg.dim_latent), np.float32))
        return "gmgan", jm, tm, jp, tp, inputs, None
    jm, tm, jp, tp = fam3.models("moving_mnist", "local_ep")
    cfg = jm.cfg
    inputs = (rng.standard_normal((4, cfg.dim_latent_l), np.float32),
              rng.standard_normal((4, cfg.dim_latent_g), np.float32),
              np.eye(cfg.n_classes, dtype=np.float32)[
                  rng.integers(0, cfg.n_classes, 4)])
    # the chain's eps, JAX's first draw of registry.apply under KEY
    eps = jax.random.normal(jax.random.fold_in(KEY, 0x5EED_0001),
                            (4, cfg.dim_latent_t),
                            jnp.dtype(cfg.compute_dtype))
    return "ssgan", jm, tm, jp, tp, inputs, {"epsilon": torch.from_numpy(
        np.array(eps))}


def _port_sample(family, tm, tp, inputs, draws):
    ts = [torch.from_numpy(a) for a in inputs]
    with torch.inference_mode():
        if family == "ssgan":
            return tm.sample(tp, *ts, draws=draws)
        return make_sampler(family, tm)[0](tp, 0, *ts)


CASES = ["gan-mnist", "gmgan", "ssgan"]


@pytest.mark.parametrize("name", CASES)
def test_calibration_and_quantized_sampler_match_jax(name, tmp_path):
    family, jm, tm, jp, tp, inputs, draws = _case(name)
    jfn = jax_make_sampler(family, jm)[0]
    jin = [jnp.asarray(a) for a in inputs]
    rec_j, rec_t = {}, {}
    with jax.disable_jit(), jq.calibrating(rec_j):
        jfn(jp, KEY, *jin)
    with tq.calibrating(rec_t):
        _port_sample(family, tm, tp, inputs, draws)
    assert sorted(rec_t) == sorted(rec_j)
    if family == "ssgan":
        assert any("Dynamic" in k for k in rec_t)
    for k, v in rec_j.items():
        assert abs(rec_t[k] - v) <= CALIB_RTOL * v, (k, rec_t[k], v)

    # JAX's scales file, loaded by the port as it is
    path = str(tmp_path / "act_scales.json")
    jq.save_scales(path, jq.scales_from_records(rec_j))
    scales = tq.load_scales(path)
    assert scales == jq.load_scales(path)
    with jq.quantized(scales):
        want = np.asarray(jax.jit(lambda k, *i: jfn(jp, k, *i))(KEY, *jin))
    with tq.quantized(scales):
        got = _port_sample(family, tm, tp, inputs, draws).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=E2E_ATOL)
    # the int8 path really ran: it is not the float sampler
    flt = _port_sample(family, tm, tp, inputs, draws).numpy()
    assert float(np.abs(got - flt).max()) > 1e-3


def test_calibrate_and_quantized_entry(monkeypatch):
    """``serve/quantize.py``: calibration from a numpy seed covers every
    intercepted layer of the sampler, raises where none is, and the
    quantized entry reuses one weight cache across calls."""
    family, jm, tm, jp, tp, _, _ = _case("gan-mnist")
    scales = calibrate(family, tm, tp, 11, n_batches=2)
    assert sorted(scales) == ["Generator.2", "Generator.3", "Generator.5",
                              "Generator.Input"]
    assert scales == calibrate(family, tm, tp, 11, n_batches=2)
    assert all(v > 0 for v in scales.values())
    (z,) = prior_inputs(family, tm.cfg, 5, 3)
    assert z.shape == (5, tm.cfg.dim_latent) and z.dtype == np.float32
    gm = fam2.models("mnist", "local_ep")[1]
    onehot, noise = prior_inputs("gmgan", gm.cfg, 6, 3)
    assert np.array_equal(onehot.sum(1), np.ones(6, np.float32))

    fn = quantized_entry(make_sampler(family, tm)[0], scales)
    with torch.inference_mode():
        a = fn(tp, 0, torch.from_numpy(z))
        b = fn(tp, 0, torch.from_numpy(z))
    assert torch.equal(a, b) and a.shape == (5, tm.cfg.data.output_dim)

    import graphical_gan_tpu_torch.serve.export as export
    monkeypatch.setattr(export, "make_sampler", lambda f, m: (
        lambda params, seed, x: x, (np.zeros((2, 3)),)))
    with pytest.raises(RuntimeError, match="recorded no layers"):
        calibrate(family, tm, tp, 0, n_batches=1)


def _no_intercepts(monkeypatch):
    """The float path as it was before the intercepts: each returns None
    without reading the context."""
    for name in ("intercept_conv2d", "intercept_deconv2d",
                 "intercept_linear"):
        monkeypatch.setattr(tq, name, lambda *a, **k: None)


def test_float_sampler_and_training_step_unchanged(monkeypatch):
    from graphical_gan_tpu_torch.train.step import make_train_step
    family, jm, tm, jp, tp, inputs, _ = _case("gan-cifar10")
    z = torch.from_numpy(inputs[0])
    fn = make_sampler(family, tm)[0]
    with torch.inference_mode():
        before = fn(tp, 0, z)
        with tq.quantized(tq.scales_from_records({
                k: 1.0 for k in ("Generator.Input", "Generator.2",
                                 "Generator.3", "Generator.5")})):
            fn(tp, 0, z)
        after = fn(tp, 0, z)
    rng = np.random.default_rng(2)
    k = tm.cfg.critic_iters
    raw = torch.from_numpy(np.stack([fam1.raw_batch(tm.cfg, rng)
                                     for _ in range(1 + k)]))

    def step_once():
        step, init_state = make_train_step(tm)
        state = init_state({n: v.clone() for n, v in tp.items()})
        gen = torch.Generator().manual_seed(5)
        state, metrics = step(state, raw, True, gen)
        return state, metrics

    state, metrics = step_once()
    with monkeypatch.context() as m:
        _no_intercepts(m)
        with torch.inference_mode():
            plain = fn(tp, 0, z)
        ref_state, ref_metrics = step_once()
    assert torch.equal(before, plain) and torch.equal(after, plain)
    for name, v in ref_state.params.items():
        assert torch.equal(state.params[name], v), name
    for name, v in ref_metrics.items():
        assert torch.equal(torch.as_tensor(metrics[name]),
                           torch.as_tensor(v)), name
