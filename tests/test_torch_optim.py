"""The port's TF1 optimizers (graphical_gan_tpu_torch/optim/optimizers.py)
against the JAX package's: 100 Adam and RMSProp updates on the same fixed
gradients (drawn with numpy), in f32, with f32 master weights under bf16
live parameters, and with bf16 moments; and ``clip_params``.

Tolerances. f32 state: each update rounds in another order (the port's
fused multi-tensor ops against XLA's), a few f32 ulps per step, so after
100 steps atol 1e-6 on parameters of size ~1 and rtol 1e-5 on the moments.
bf16 live parameters and bf16 moments: the f32 values behind them agree as
above, but a value near a bf16 rounding boundary may round the other way,
so one bf16 step (up to 2^-7 relative, at the low end of a binade) is
allowed; and a moment that rounds the
other way changes that step's update by up to 2^-8 of it (about 4e-7 at
lr 1e-4), so the f32 masters behind bf16 moments get atol 1e-5 over the
100 steps (2.4e-6 seen).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.objectives.common import OptSpec as JaxSpec
from graphical_gan_tpu.optim.optimizers import (
    clip_params as jax_clip, make_optimizer as jax_make)
from graphical_gan_tpu_torch.objectives.common import OptSpec
from graphical_gan_tpu_torch.optim.optimizers import (
    clip_params, make_optimizer)

SHAPES = {"Discriminator.1.Filters": (5, 5, 3, 8),
          "Discriminator.1.Biases": (8,), "Generator.BN1.scale": (64,)}
STEPS = 100


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(1000 + step)
    return {n: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0)).astype("float32")
            for n, s in SHAPES.items()}


def _run(kind, low_byte):
    jspec = JaxSpec(kind=kind, lr=1e-4, beta1=0.5, beta2=0.9)
    tspec = OptSpec(kind=kind, lr=1e-4, beta1=0.5, beta2=0.9)
    pdt = "bfloat16" if low_byte else "float32"
    mdt = jnp.bfloat16 if low_byte else None
    jopt = jax_make(jspec, master_weights=low_byte, moment_dtype=mdt)
    topt = make_optimizer(tspec, master_weights=low_byte,
                          moment_dtype=torch.bfloat16 if low_byte else None)
    p0 = _params()
    jp = {n: jnp.asarray(v, pdt) for n, v in p0.items()}
    # copies: the port updates its parameters in place, and JAX may still
    # read the numpy buffer behind jp after jnp.asarray has returned
    tp = {n: torch.tensor(v).to(getattr(torch, pdt)) for n, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for step in range(STEPS):
        g = _grads(step)
        jp, js = jupdate({n: jnp.asarray(v, pdt) for n, v in g.items()},
                         js, jp)
        topt.update({n: torch.from_numpy(v).to(getattr(torch, pdt))
                     for n, v in g.items()}, ts, tp)
    return jp, js, tp, ts


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_close(got, want):
    got, want = _f32(got), _f32(want)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_f32_updates_match_jax(kind):
    jp, js, tp, ts = _run(kind, low_byte=False)
    for n in SHAPES:
        np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]), atol=1e-6,
                                   rtol=0)
        for slot in (("m", "v") if kind == "adam" else ("ms",)):
            np.testing.assert_allclose(_f32(ts[slot][n]), _f32(js[slot][n]),
                                       rtol=1e-5, atol=1e-12)
    if kind == "adam":
        assert int(ts["t"]) == int(js["t"]) == STEPS
        assert ts["t"].dtype == torch.int32 and ts["t"].device.type == "cpu"
    # the parameters moved: the test is not comparing two no-ops
    assert float(np.abs(_f32(tp["Discriminator.1.Biases"])
                        - _params()["Discriminator.1.Biases"]).max()) > 1e-4


@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_master_weights_and_bf16_moments_match_jax(kind):
    jp, js, tp, ts = _run(kind, low_byte=True)
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(ts["master"][n]),
                                   _f32(js["master"][n]), atol=1e-5, rtol=0)
        _bf16_close(tp[n], jp[n])
        for slot in (("m", "v") if kind == "adam" else ("ms",)):
            assert ts[slot][n].dtype == torch.bfloat16
            _bf16_close(ts[slot][n], js[slot][n])


def test_rmsprop_starts_at_ones_and_adam_at_zeros():
    tp = {n: torch.from_numpy(v) for n, v in _params().items()}
    rms = make_optimizer(OptSpec(kind="rmsprop")).init(tp)
    adam = make_optimizer(OptSpec(kind="adam")).init(tp)
    assert all(bool((v == 1).all()) for v in rms["ms"].values())
    assert all(bool((v == 0).all()) for v in adam["m"].values())
    assert int(adam["t"]) == 0 and "master" not in adam


def test_clip_params_matches_jax():
    p = {n: v * 0.05 for n, v in _params(3).items()}
    want = jax_clip({n: jnp.asarray(v) for n, v in p.items()}, 0.01,
                    "Discriminator")
    tp = {n: torch.from_numpy(v.copy()) for n, v in p.items()}
    clip_params(tp, 0.01, "Discriminator")
    for n in SHAPES:
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(want[n]))
    assert float(tp["Generator.BN1.scale"].abs().max()) > 0.01
