"""The port's wali-gp losses against the JAX package's, on the CPU at dim 8,
B 4, f32, from the same parameters (``params_from_jax``), raw batch and
random draws: the JAX ``p_z`` and ``alpha`` are taken out of the JAX
registry under the keys the JAX step uses (``fold_in(key, 0)`` for the G
update, ``fold_in(key, 1 + i)`` for D update i) and handed to the port.

Checks ``q_z``, ``fake_x``, ``disc_real``, ``disc_fake``, the gradient
penalty, ``gen_cost``, ``disc_cost``, and the gradients of ``gen_loss``
with respect to the G+E parameters and of ``disc_loss`` with respect to
the D parameters (the latter through the penalty's double backward).

Tolerances: f32 sums taken in other orders through up to 9 layers: values
to atol 1e-4 scaled by max(1, max |ref|); each gradient leaf to
max |Δ| <= 1e-4 · max(1e-2, max |ref leaf|) (relative to the leaf's own
size, which spans four orders of magnitude across layers).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.core.registry import next_rng_key
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.core.registry import merge, partition
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax

B = 4
STEP_KEY = jax.random.PRNGKey(7)
KW = dict(dim=8, batch_size=B)


@pytest.fixture(scope="module")
def setup():
    jm = JaxM(jax_cfg("cifar10", "wali-gp", **KW))
    tm = GanInferenceModel(gan_inference_defaults("cifar10", "wali-gp", **KW))
    np_params = {k: v.numpy() for k, v in tm.init(3, "cpu").items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = params_from_jax(np_params, "cpu")
    raw = np.random.default_rng(0).integers(0, 256, (B, 3072)).astype(
        np.float32)
    return jm, tm, jp, tp, raw


def jax_draws(jm, jp, raw, key):
    """(p_z, alpha) the JAX losses draw under ``key``."""
    def f():
        p_z = jm._graph(jnp.asarray(raw))["p_z"]
        return p_z, jax.random.uniform(next_rng_key(), (raw.shape[0], 1))
    p_z, alpha = registry.apply(f, jp, key)
    return torch.from_numpy(np.array(p_z)), torch.from_numpy(np.array(alpha))


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    size = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * size, rtol=0)


def _close_grads(got, want):
    assert set(got) == set(want)
    for name in sorted(want):
        ref = np.asarray(want[name])
        d = float(np.abs(got[name].numpy() - ref).max())
        assert d <= 1e-4 * max(1e-2, float(np.abs(ref).max())), (name, d)


def test_graph_and_costs_match(setup):
    jm, tm, jp, tp, raw = setup
    d_key = jax.random.fold_in(STEP_KEY, 1)
    p_z, alpha = jax_draws(jm, jp, raw, d_key)

    def jax_side():
        t = jm._graph(jnp.asarray(raw))
        g, d, _ = jm._costs(t)
        return {k: t[k] for k in ("q_z", "fake_x", "disc_real",
                                  "disc_fake")}, g, d

    want, g_ref, d_ref = registry.apply(jax_side, jp, d_key)
    t = tm._graph(tp, torch.from_numpy(raw), p_z=p_z)
    for k, v in want.items():
        _close(t[k], v)
    gp_ref = float(d_ref) - (float(jnp.mean(want["disc_fake"]))
                             - float(jnp.mean(want["disc_real"])))
    gp = tm.gradient_penalty(tp, t, alpha).detach()
    assert abs(float(gp) - gp_ref) <= 1e-4 * max(1.0, abs(gp_ref))
    g, _ = tm.gen_loss(tp, torch.from_numpy(raw), p_z=p_z)
    d, aux = tm.disc_loss(tp, torch.from_numpy(raw), p_z=p_z, alpha=alpha)
    assert abs(float(g) - float(g_ref)) <= 1e-4 * max(1.0, abs(float(g_ref)))
    assert abs(float(d) - float(d_ref)) <= 1e-4 * max(1.0, abs(float(d_ref)))
    assert float(aux["gp"]) == float(gp)


@pytest.mark.parametrize("player", ["gen", "disc"])
def test_loss_gradients_match_jax_grad(setup, player):
    jm, tm, jp, tp, raw = setup
    names = jm.GEN_PLAYER if player == "gen" else jm.DISC_PLAYER
    key = jax.random.fold_in(STEP_KEY, 0 if player == "gen" else 1)
    p_z, alpha = jax_draws(jm, jp, raw, key)
    j_player, j_rest = registry.partition(jp, names)

    def jax_loss(pp):
        loss_fn = jm.gen_loss if player == "gen" else jm.disc_loss
        return registry.apply(lambda: loss_fn(jnp.asarray(raw))[0],
                              registry.merge(pp, j_rest), key)

    want = jax.grad(jax_loss)(j_player)
    t_player, _ = partition(tp, names)
    leaves = {n: p.clone().requires_grad_(True) for n, p in t_player.items()}
    merged = merge(tp, leaves)
    raw_t = torch.from_numpy(raw)
    loss = tm.gen_loss(merged, raw_t, p_z=p_z)[0] if player == "gen" \
        else tm.disc_loss(merged, raw_t, p_z=p_z, alpha=alpha)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close_grads(dict(zip(leaves, grads)), want)


def test_disc_loss_leaves_players_out_of_the_graph(setup):
    """E and G run under no_grad in disc_loss: a G+E leaf gets no
    gradient, and the D leaves get theirs through the penalty."""
    _, tm, _, tp, raw = setup
    leaves = {n: p.clone().requires_grad_(True) for n, p in tp.items()}
    loss, _ = tm.disc_loss(leaves, torch.from_numpy(raw),
                           generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    got = dict(zip(leaves, grads))
    assert all(got[n] is None for n in got if not n.startswith("Disc"))
    assert all(got[n] is not None for n in got if n.startswith("Disc"))


def test_draws_come_from_the_generator(setup):
    _, tm, _, tp, raw = setup
    out = [tm.disc_loss(tp, torch.from_numpy(raw),
                        generator=torch.Generator().manual_seed(s))[0]
           for s in (1, 1, 2)]
    assert float(out[0]) == float(out[1]) != float(out[2])


@pytest.mark.parametrize("mode", ["ali", "wali", "alice"])
def test_other_modes_match_jax(mode):
    """The cifar10 modes this file's wali-gp cases stand beside: gen_cost
    and disc_cost against JAX's from the same params, batch and draws
    (atol 1e-4 of max(1, |ref|)); their gradients are held in
    ``test_torch_family1_model_cifar10_*``."""
    from _torch_family1 import jax_draws, models, to_torch
    jm, tm, jp, tp = models("cifar10", mode)
    raw = np.random.default_rng(0).integers(0, 256, (B, 3072)).astype(
        np.float32)
    key = jax.random.fold_in(STEP_KEY, 3)

    @jax.jit
    def costs(params, r):
        return registry.apply(lambda: jm._costs(jm._graph(r))[:2], params,
                              key)

    g_ref, d_ref = costs(jp, jnp.asarray(raw))
    draws = to_torch(jax_draws(tm.cfg, key))
    g, _ = tm.gen_loss(tp, torch.from_numpy(raw), draws=draws)
    d, _ = tm.disc_loss(tp, torch.from_numpy(raw), draws=draws)
    for got, want in ((g, g_ref), (d, d_ref)):
        assert abs(float(got) - float(want)) <= 1e-4 * max(
            1.0, abs(float(want)))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_opt_specs_match_jax(dataset):
    """Every mode's presets equal JAX's: (G+E, D), D None for the modes
    without a discriminator (k = 0); ali passes beta2."""
    from graphical_gan_tpu_torch.core.config import GAN_INFERENCE_MODES
    for mode in GAN_INFERENCE_MODES:
        jspecs = JaxM(jax_cfg(dataset, mode)).opt_specs()
        tspecs = GanInferenceModel(
            gan_inference_defaults(dataset, mode)).opt_specs()
        for j, t in zip(jspecs, tspecs):
            assert (j is None) == (t is None), mode
            if j is not None:
                assert (j.kind, j.lr, j.beta1, j.beta2, j.eps,
                        j.weight_clip) == (t.kind, t.lr, t.beta1, t.beta2,
                                           t.eps, t.weight_clip), mode


@pytest.mark.parametrize("objective", ["wali", "wgan", "wali_gp", "wgan-gp",
                                       "ali", "alice"])
def test_optimizer_for_matches_jax(objective):
    """The port's preset table equals JAX's for every objective name."""
    from graphical_gan_tpu.objectives.common import optimizer_for as jax_of
    from graphical_gan_tpu_torch.objectives.common import optimizer_for
    for kw in ({}, dict(lr=3e-4, beta1=0.3, beta2=0.99)):
        j, t = jax_of(objective, **kw), optimizer_for(objective, **kw)
        assert (j.kind, j.lr, j.beta1, j.beta2, j.eps, j.weight_clip) \
            == (t.kind, t.lr, t.beta1, t.beta2, t.eps, t.weight_clip)


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_sigmoid_ce_matches_jax(label):
    """Same logits through both; f32 elementwise terms summed in another
    order: rtol 1e-6."""
    from graphical_gan_tpu.objectives.common import sigmoid_ce as jax_ce
    from graphical_gan_tpu_torch.objectives.common import sigmoid_ce
    logits = np.random.default_rng(0).normal(0, 30, (257,)).astype(
        np.float32)
    got = float(sigmoid_ce(torch.from_numpy(logits), label))
    want = float(jax_ce(jnp.asarray(logits), label))
    assert got == pytest.approx(want, rel=1e-6)
