"""The port's SSGAN pieces against the JAX package's, at the JAX tests'
sizes (dim 4, dim_op 16, B 2, 64x64 frames): the config and its defaults,
every parameter's name and shape against the JAX ``init``, ``conv3d`` and
its fans at the 3dcnn's temporal strides for LEN 3, 4 and 16, the latent
chains under every pos_mode and both operator forms, the weighted CE, and
the serving and hook forwards (``sample``, ``reconstruct``,
``disentangle``). Tolerances, f32: values to 1e-5 absolute where one op
runs (the chains, the CE), 1e-4 of max(1, |ref|) through a whole network
(``_torch_family1.close``). ``remat`` on dict batches with
``accum_steps=2`` is held bit for bit to the step without it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import ssgan_defaults as jax_defaults
from graphical_gan_tpu.models.ssgan import SSGanModel as JaxM
from graphical_gan_tpu.objectives import gan_inference as jax_objs
from graphical_gan_tpu.ops import conv as jax_conv
from graphical_gan_tpu.ops import initializers as jax_inits
from graphical_gan_tpu_torch.core.config import SSGanConfig, ssgan_defaults
from graphical_gan_tpu_torch.models.common import Draws
from graphical_gan_tpu_torch.objectives import gan_inference as objs
from graphical_gan_tpu_torch.ops import conv3d, initializers as inits
from graphical_gan_tpu_torch.train.step import make_train_step

from _torch_family1 import close
from _torch_gmgan import compiled
from _torch_ssgan import (
    POS_MODES, as_jax, as_torch, config_kw, models, raw_batch)
from _torch_threads import one_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("dataset", ["moving_mnist", "chairs"])
def test_defaults_and_properties_match_jax(dataset):
    for mode in ("local_ep", "alice-z"):
        mine = ssgan_defaults(dataset, mode)
        ref = jax_defaults(dataset, mode)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        np.testing.assert_array_equal(mine.ratio, ref.ratio)
        for prop in ("dim_latent_t", "output_dim", "conditional"):
            assert getattr(mine, prop) == getattr(ref, prop), prop
        assert mine.data.normalization == ref.data.normalization
    assert {f.name for f in dataclasses.fields(SSGanConfig)} == {
        f.name for f in dataclasses.fields(type(ref))}


def test_defaults_refuse_unknown_modes():
    for kw in ({"mode": "vegan"}, {"pos_mode": "smoother"},
               {"ali_mode": "concat"}, {"op_dyn_mode": "mlp"}):
        mode = kw.pop("mode", "local_ep")
        with pytest.raises(ValueError):
            ssgan_defaults("moving_mnist", mode, **kw)


@pytest.mark.parametrize("dataset,mode,extra", [
    ("moving_mnist", "ali", dict(ali_mode="3dcnn", seq_len=16)),
    ("chairs", "local_epce-z", dict(pos_mode="gsp", bn=True, seq_len=3)),
    ("moving_mnist", "alice-z", dict(ali_mode="concat_z",
                                     pos_mode="inverse", bn=True)),
])
def test_param_specs_match_jax_init(dataset, mode, extra):
    kw = config_kw(**extra)
    ref = jax.eval_shape(JaxM(jax_defaults(dataset, mode, **kw)).init, KEY)
    from graphical_gan_tpu_torch.models.ssgan import SSGanModel
    specs = SSGanModel(ssgan_defaults(dataset, mode, **kw)).param_specs()
    assert {k: tuple(v.shape) for k, v in ref.items()} == {
        k: tuple(v[1]) for k, v in specs.items()}


@pytest.mark.parametrize("fan", [(3, 8, 4, 4, 2, 2), (8, 16, 4, 4, 2, 1),
                                 (16, 32, 4, 4, 2, 2), (5, 7, 3, 2, 1, 3)])
def test_conv3d_fans_match_jax(fan):
    assert inits.conv3d_fans(*fan) == jax_inits.conv3d_fans(*fan)


@pytest.mark.parametrize("length,stride_len", [
    (3, 2), (4, 1), (4, 2), (16, 1), (16, 2), (2, 2)])
def test_conv3d_matches_jax(length, stride_len):
    """The 3dcnn's k4 (time and space) stride-2 SAME conv3d over NDHWC,
    forward and gradients, DHWIO filters: the odd SAME pad goes high."""
    rng = np.random.default_rng(length * 10 + stride_len)
    x = rng.standard_normal((2, length, 16, 16, 3)).astype(np.float32)
    w = rng.standard_normal((4, 4, 4, 3, 5)).astype(np.float32) * 0.1
    b = rng.standard_normal(5).astype(np.float32)
    g = rng.standard_normal((2, -(-length // stride_len), 8, 8, 5)).astype(
        np.float32)

    def jax_fn(x, w, b):
        p = {"D.Filters": w, "D.Biases": b}
        return registry.apply(lambda: jax_conv.conv3d(
            "D", 4, 3, 5, 4, x, stride=2, stride_len=stride_len), p, None)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    refs = (ref,) + vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    out = conv3d({"D.Filters": xs[1], "D.Biases": xs[2]}, "D", xs[0],
                 stride=2, stride_len=stride_len)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for got, want in zip((out,) + grads, refs):
        close(got, want)


@pytest.mark.parametrize("op", ["res", "res_w"])
@pytest.mark.parametrize("pos_mode", POS_MODES)
def test_posterior_chain_matches_jax(pos_mode, op):
    jm, tm, jp, tp = models("moving_mnist", "local_ep", pos_mode=pos_mode,
                            op_dyn_mode=op, seq_len=5)
    pre = np.random.default_rng(1).standard_normal(
        (2, 5, tm.cfg.dim_latent_l)).astype(np.float32)
    ref = registry.apply(lambda: jm.dynamic_extractor(jnp.asarray(pre)), jp,
                         KEY)
    got = tm.dynamic_extractor(tp, torch.from_numpy(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    if pos_mode == "naive_mean_field":
        np.testing.assert_array_equal(got.numpy(), pre)


@pytest.mark.parametrize("op", ["res", "res_w"])
def test_prior_chain_shares_one_epsilon_and_matches_jax(op):
    """One eps per call of the chain, reused at every step (the
    reference's quirk), drawn under the name ``epsilon``."""
    jm, tm, jp, tp = models("moving_mnist", "local_ep", op_dyn_mode=op,
                            seq_len=5)
    z0 = np.random.default_rng(2).standard_normal(
        (2, tm.cfg.dim_latent_l)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = registry.apply(lambda: jm.dynamic_generator(jnp.asarray(z0)), jp,
                         key)
    eps = jax.random.normal(jax.random.fold_in(key, 0x5EED_0001),
                            (2, tm.cfg.dim_latent_t))
    seen = []

    class Spy(Draws):
        def normal(self, name, shape, dtype, device):
            seen.append(name)
            return super().normal(name, shape, dtype, device)

    got = tm.dynamic_generator(tp, torch.from_numpy(z0), Spy(
        {"epsilon": torch.from_numpy(np.array(eps))}))
    assert seen == ["epsilon"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_weighted_local_epce_matches_jax():
    rng = np.random.default_rng(3)
    fake = [rng.standard_normal(4).astype(np.float32) for _ in range(5)]
    real = [rng.standard_normal(4).astype(np.float32) for _ in range(5)]
    ratio = ssgan_defaults("moving_mnist", seq_len=4).ratio
    for rec in (None, 0.25):
        want = jax_objs.weighted_local_epce(
            [jnp.asarray(f) for f in fake], [jnp.asarray(r) for r in real],
            ratio, None if rec is None else jnp.float32(rec))
        got = objs.weighted_local_epce(
            [torch.from_numpy(f) for f in fake],
            [torch.from_numpy(r) for r in real], ratio,
            None if rec is None else torch.tensor(rec))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(float(g), float(w), atol=1e-6,
                                       rtol=0)
        for g, w in zip(got[2] + got[3], want[2] + want[3]):
            np.testing.assert_allclose(float(g), float(w), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("dataset,extra", [
    ("moving_mnist", dict(pos_mode="gsp", bn=True)),
    ("chairs", dict(pos_mode="inverse", seq_len=3)),
])
def test_sample_reconstruct_disentangle_match_jax(dataset, extra):
    """The serving entries' and the hook's forwards, one JAX compile per
    config; sample's eps is JAX's first draw under its key."""
    jm, tm, jp, tp = models(dataset, "local_ep", **extra)
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    raw = raw_batch(cfg, rng)
    x, y = (raw["x"], raw["y"]) if isinstance(raw, dict) else (raw, None)
    z0 = rng.standard_normal((2, cfg.dim_latent_l)).astype(np.float32)
    zg = rng.standard_normal((2, cfg.dim_latent_g)).astype(np.float32)
    dis_g = np.tile(zg[:1], (2, 1))
    dis_y = None if y is None else y[::-1].copy()
    key = jax.random.PRNGKey(9)

    @jax.jit
    def forwards(p, x, y, z0, zg, dis_g, dis_y):
        def run():
            return (jm.sample(z0, zg, y), jm.reconstruct(x, y),
                    jm.disentangle(x, y, dis_g, dis_y))
        return registry.apply(run, p, key)

    args = (jp,) + tuple(as_jax(a) if a is not None else None
                         for a in (x, y, z0, zg, dis_g, dis_y))
    refs = compiled(forwards, *args)(*args)
    eps = jax.random.normal(jax.random.fold_in(key, 0x5EED_0001),
                            (2, cfg.dim_latent_t))

    def t(a):
        return None if a is None else as_torch(a)

    got = (tm.sample(tp, t(z0), t(zg), t(y),
                     draws={"epsilon": torch.from_numpy(np.array(eps))}),
           tm.reconstruct(tp, t(x), t(y)),
           tm.disentangle(tp, t(x), t(y), t(dis_g), t(dis_y)))
    for g, r in zip(got, refs):
        assert g.shape == (2, cfg.seq_len, cfg.output_dim)
        close(g, r)


def test_remat_on_dict_batches_is_bit_identical():
    """remat (with accum_steps=2, so each dict update is split) replays the
    step's generator in the recompute: the same parameters and costs, bit
    for bit."""
    out = []
    for remat in (False, True):
        _, tm, _, tp = models("moving_mnist", "local_epce-z",
                              pos_mode="inverse", remat=remat, accum_steps=2,
                              batch_size=4, seq_len=3)
        step, init = make_train_step(tm)
        state = init(tp)
        rng = np.random.default_rng(1)
        gen = torch.Generator().manual_seed(3)
        metrics = []
        for it in range(2):
            raw = as_torch(raw_batch(tm.cfg, rng, lead=(2,)))
            state, m = step(state, raw, it > 0, gen)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append((state, metrics))
    (a, ma), (b, mb) = out
    assert ma == mb
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name


def test_a_conditional_model_refuses_a_bare_video_batch():
    _, tm, _, tp = models("moving_mnist", "ali")
    with pytest.raises(ValueError, match="conditional"):
        tm.gen_loss(tp, torch.zeros(2, 4, 4096))
