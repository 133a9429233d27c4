"""The port's GanInferenceModel against the JAX package's, on the CPU: JAX
``init`` -> ``params_from_jax`` -> ``sample`` / ``encode`` /
``reconstruct`` from the same numpy inputs, with the JAX Pallas kernels off
and on (interpret mode), in f32 and bf16.

Tolerances: f32 atol 1e-4 end to end; bf16 max |Δ| within 2e-2 of
max(1, max |ref|).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu.ops import pallas as jax_pallas
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
from _torch_threads import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
B = 4
_JAX_PARAMS = {}


def _models(dataset, mode, dtype):
    """(jax model, port model, jax params, port params).

    The JAX parameters come from the JAX registry's init traced through the
    serving forward (``reconstruct`` creates every G and E parameter); each
    value depends only on the key and the parameter's name, so they equal
    those of ``GanInferenceModel.init`` without tracing its losses. They do
    not depend on the compute dtype, so each (dataset, mode) inits once."""
    kw = dict(dim=8, batch_size=B, compute_dtype=dtype)
    if dataset == "celeba":  # the face script's widths are dim_g / dim_d
        kw.update(dim_g=8, dim_d=8)
    jm = JaxM(jax_cfg(dataset, mode, **kw))
    tm = GanInferenceModel(gan_inference_defaults(dataset, mode, **kw))
    if (dataset, mode) not in _JAX_PARAMS:
        raw = jnp.zeros((B, jm.cfg.data.output_dim), jnp.float32)
        _JAX_PARAMS[(dataset, mode)] = registry.init(
            lambda: jm.reconstruct(raw), KEY)[1]
    jp = _JAX_PARAMS[(dataset, mode)]
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, tm, jp, tp


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (B, cfg.data.output_dim)).astype(np.float32)
    noise = rng.standard_normal((B, cfg.dim_latent)).astype(np.float32)
    return raw, noise


def _close(got, want, dtype):
    """f32: atol 1e-4. bf16: relative error ||Δ|| / ||ref|| < 2e-2; the JAX
    package without Pallas rounds to bf16 after the conv, the bias and the
    activation where the port (like the Pallas kernels) stays in f32 until
    the epilogue, so single elements may differ by several bf16 steps."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < 2e-2


def _forwards(jm, tm, jp, tp, raw, noise, dtype):
    td = getattr(torch, dtype)

    @jax.jit
    def jax_fwd(params, r, n):
        def run(f):
            return registry.apply(f, params, KEY).astype(jnp.float32)
        return {"sample": run(lambda: jm.sample(n)),
                "encode": run(lambda: jm.encode(r)),
                "reconstruct": run(lambda: jm.reconstruct(r))}

    want = jax_fwd(jp, jnp.asarray(raw), jnp.asarray(noise, jnp.dtype(dtype)))
    got = {"sample": tm.sample(tp, torch.from_numpy(noise).to(td)),
           "encode": tm.encode(tp, torch.from_numpy(raw)),
           "reconstruct": tm.reconstruct(tp, torch.from_numpy(raw))}
    return {k: (np.asarray(want[k]), got[k]) for k in got}


@pytest.mark.parametrize("dataset,mode,dtype,pallas", [
    ("cifar10", "wali-gp", "float32", False),
    ("cifar10", "wali-gp", "float32", True),
    ("cifar10", "wali-gp", "bfloat16", False),
    ("cifar10", "wali-gp", "bfloat16", True),
    ("svhn", "ali", "float32", False),   # BN off
    ("svhn", "ali", "bfloat16", False),
])
def test_forwards_match_jax(dataset, mode, dtype, pallas):
    jm, tm, jp, tp = _models(dataset, mode, dtype)
    raw, noise = _inputs(tm.cfg)
    jax_pallas.enable_pallas(pallas)
    try:
        outs = _forwards(jm, tm, jp, tp, raw, noise, dtype)
    finally:
        jax_pallas.enable_pallas(False)
    for name, (want, got) in outs.items():
        assert got.dtype == getattr(torch, dtype), name
        _close(got, want, dtype)


def test_init_statistics_follow_the_scheme():
    cfg = gan_inference_defaults("cifar10", "wali-gp", dim=8)
    tm = GanInferenceModel(cfg)
    p = tm.init(seed=3, device="cpu")
    assert torch.equal(p["Generator.BN1.scale"], torch.ones(4 * 4 * 4 * 8))
    assert torch.equal(p["Extractor.1.Biases"], torch.zeros(8))
    # E.1: he stdev sqrt(4 / (3*25 + 8*25//4)) -> bound stdev*sqrt(3)
    bound = (4.0 / (75 + 50)) ** 0.5 * 3 ** 0.5
    w = p["Extractor.1.Filters"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert torch.equal(w, tm.init(seed=3, device="cpu")["Extractor.1.Filters"])
    assert not torch.equal(w, tm.init(seed=4, device="cpu")[
        "Extractor.1.Filters"])


def test_batch_statistics_couple_rows():
    """Serving semantics: with BN on, a row's output depends on its batch
    (the reason for the server's padding policies)."""
    _, tm, _, tp = _models("cifar10", "wali-gp", "float32")
    _, noise = _inputs(tm.cfg)
    full = tm.sample(tp, torch.from_numpy(noise))
    sub = tm.sample(tp, torch.from_numpy(noise[:2]))
    assert not torch.allclose(full[:2], sub, atol=1e-5)


@pytest.mark.parametrize("dataset,mode", [("mnist", "ali"),
                                          ("celeba", "ali"),
                                          ("cifar10", "vegan-kl"),
                                          ("svhn", "vae")])
def test_later_slices_match_jax(dataset, mode):
    """The datasets and posterior heads of the rest of family 1 (mnist's
    crop and sigmoid, celeba's four stages and input noise, learn_std):
    the serving forwards against JAX's in f32, with JAX's draws (celeba's
    dequantization noise, the posterior's eps) handed to the port."""
    from _torch_family1 import jax_draws, to_torch
    jm, tm, jp, tp = _models(dataset, mode, "float32")
    raw, noise = _inputs(tm.cfg)
    want = _forwards(jm, tm, jp, tp, raw, noise, "float32")
    draws = to_torch(jax_draws(tm.cfg, KEY))
    got = {"encode": tm.encode(tp, torch.from_numpy(raw), draws=draws),
           "reconstruct": tm.reconstruct(tp, torch.from_numpy(raw),
                                         draws=draws)}
    for name, (ref, first) in want.items():
        _close(got.get(name, first), ref, "float32")


def test_init_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp",
                                                  dim=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(seed=0)
