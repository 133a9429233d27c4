"""Shared helpers of the family-1 parity tests (``test_torch_family1_*``):
the same parameters, raw batches and random draws through the JAX package
and the port.

The JAX losses draw each random number from the registry's stream, key n
being ``fold_in(key, 0x5EED0000 + n)`` for the n-th draw of one
``registry.apply`` (``graphical_gan_tpu/core/registry.py:next_rng_key``).
:func:`jax_draws` replays that stream in the JAX graph's order and returns
the draws under the port's names (``graphical_gan_tpu_torch/models/
gan_inference.py``), so the port can be handed exactly what JAX drew.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gan_inference_defaults as jax_cfg
from graphical_gan_tpu.models.gan_inference import GanInferenceModel as JaxM
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax

B = 4
Z_SAMPLES = 16


def config_kw(dataset: str, **extra) -> dict:
    kw = dict(dim=8, batch_size=B, z_samples=Z_SAMPLES)
    if dataset == "celeba":
        kw.update(dim_g=8, dim_d=8)
    kw.update(extra)
    return kw


def models(dataset: str, mode: str, seed: int = 3, **extra):
    """(jax model, port model, jax params, port params): the port's init,
    handed to both."""
    kw = config_kw(dataset, **extra)
    jm = JaxM(jax_cfg(dataset, mode, **kw))
    tm = GanInferenceModel(gan_inference_defaults(dataset, mode, **kw))
    np_params = {k: v.numpy() for k, v in tm.init(seed, "cpu").items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jm, tm, jp, params_from_jax(np_params, "cpu")


def raw_batch(cfg, rng: np.random.Generator, lead=()) -> np.ndarray:
    shape = tuple(lead) + (cfg.batch_size, cfg.data.output_dim)
    if cfg.data.normalization == "unit":
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, 256, shape).astype(np.float32)


class _Stream:
    def __init__(self, key):
        self.key, self.n = key, 0

    def next(self):
        self.n += 1
        return jax.random.fold_in(self.key, 0x5EED_0000 + self.n)


def jax_draws(cfg, key, batch: int = B) -> dict:
    """The draws one JAX ``gen_loss`` / ``disc_loss`` call makes under
    ``key``, by the port's names, as numpy arrays."""
    s = _Stream(key)
    mode, z = cfg.mode, cfg.dim_latent
    cdt = jnp.dtype(cfg.compute_dtype)
    out = {}
    stochastic = cfg.type_q in ("learn_std", "fix_std") \
        and cfg.dataset != "celeba"
    if cfg.data.normalization == "dequant":
        out["dequant"] = jax.random.uniform(s.next(),
                                            (batch, cfg.data.output_dim))
    if stochastic:
        out["eps_q"] = jax.random.normal(s.next(), (batch, z), jnp.float32)
    out["p_z"] = jax.random.normal(s.next(), (batch, z), cdt)
    if stochastic:
        out["eps_rec"] = jax.random.normal(s.next(), (batch, z), jnp.float32)

    def d_noise(prefix):
        for i, w in enumerate((z, 1024, 512, 256)):
            out[f"{prefix}{i}"] = jax.random.normal(s.next(), (batch, w), cdt)

    if mode in ("vegan", "vegan-wgan-gp"):
        d_noise("d_real")
        d_noise("d_fake")
    if mode == "vegan-wgan-gp":
        out["alpha"] = jax.random.uniform(s.next(), (batch, 1))
        d_noise("gp_noise")
    elif mode == "wali-gp":
        out["alpha"] = jax.random.uniform(s.next(), (batch, 1))
    elif mode in ("vegan-kl", "vegan-ikl", "vegan-jsd"):
        key = s.next()
        shape = (cfg.z_samples, z)
        if mode == "vegan-ikl":
            out["z_prior"] = jax.random.normal(key, shape)
        else:
            k_mix, k_prior = jax.random.split(key)
            mix = k_mix if mode == "vegan-jsd" else key
            k_idx, k_eps = jax.random.split(mix)
            out["mix_idx"] = jax.random.randint(k_idx, (cfg.z_samples,), 0,
                                                batch)
            out["mix_eps"] = jax.random.normal(k_eps, shape)
            if mode == "vegan-jsd":
                out["z_prior"] = jax.random.normal(k_prior, shape)
    return {k: np.asarray(v) for k, v in out.items()}


def to_torch(draws: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def close(got, want, atol=1e-4):
    """Values: atol scaled by max(1, max |ref|)."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    size = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol * size, rtol=0)


def close_grads(got, want, rtol=1e-4):
    """Each gradient leaf to max |Δ| <= rtol · max(1e-2, max |ref leaf|,
    1e-2 · max |ref| over the player): f32 sums taken in other orders. The
    last term is for the biases of the convs before a BN, whose gradient is
    zero in exact arithmetic and rounding noise of the order of 1e-7 of
    the player's largest on both sides."""
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for name in sorted(want):
        ref = np.asarray(want[name])
        d = float(np.abs(got[name].numpy() - ref).max())
        bound = rtol * max(1e-2, float(np.abs(ref).max()), 1e-2 * top)
        assert d <= bound, (name, d, bound)


def loss_grads(jm, tm, jp, tp, raw, key, player):
    """(JAX loss, JAX grads, port loss, port grads) of one player's loss
    w.r.t. that player's parameters, from the same params, batch and
    draws."""
    names = jm.GEN_PLAYER if player == "gen" else jm.DISC_PLAYER
    j_player, j_rest = registry.partition(jp, names)
    loss_fn = jm.gen_loss if player == "gen" else jm.disc_loss

    @jax.jit
    def jax_loss(pp, r):
        return registry.apply(lambda: loss_fn(r)[0],
                              registry.merge(pp, j_rest), key)

    j_loss, j_grads = jax.value_and_grad(jax_loss)(j_player, jnp.asarray(raw))
    draws = to_torch(jax_draws(tm.cfg, key, raw.shape[0]))
    t_player = {n: p.clone().requires_grad_(True) for n, p in tp.items()
                if any(s in n for s in names)}
    merged = dict(tp, **t_player)
    raw_t = torch.from_numpy(raw)
    fn = tm.gen_loss if player == "gen" else tm.disc_loss
    t_loss, _ = fn(merged, raw_t, draws=draws)
    t_grads = torch.autograd.grad(t_loss, list(t_player.values()))
    return (float(j_loss), j_grads, t_loss.detach(),
            dict(zip(t_player, t_grads)))


def check_losses(dataset: str, mode: str, player: str, seed: int = 0):
    """One player's loss and its gradients, port against JAX, at dim 8, B 4,
    f32: values to atol 1e-4 of max(1, |ref|), gradients per
    :func:`close_grads`."""
    jm, tm, jp, tp = models(dataset, mode)
    if player == "disc" and not tm.cfg.has_discriminator:
        raise ValueError(f"{mode} has no discriminator")
    raw = raw_batch(tm.cfg, np.random.default_rng(seed))
    key = jax.random.fold_in(jax.random.PRNGKey(7), seed)
    j_loss, j_grads, t_loss, t_grads = loss_grads(jm, tm, jp, tp, raw, key,
                                                  player)
    close(t_loss, j_loss)
    close_grads(t_grads, j_grads)


def player_cases(modes):
    """(mode, player) pairs: every mode's G+E loss, and the D loss of the
    modes with a discriminator."""
    from graphical_gan_tpu_torch.core.config import VEGAN_DIVERGENCE_MODES
    return [(m, p) for m in modes for p in ("gen", "disc")
            if p == "gen" or m not in VEGAN_DIVERGENCE_MODES]


def run_steps(dataset: str, mode: str, iters: int = 3, **extra):
    """(JAX state, port state, per-iteration (JAX, port) costs) after
    ``iters`` iterations of the JAX ``make_train_step`` and the port's from
    the same params, batches and draws: update j of iteration ``it`` draws
    under ``fold_in(fold_in(base, it), j)``, as the JAX step keys its G
    (j = 0) and D (j = 1 + i) updates."""
    from graphical_gan_tpu.train.step import make_train_step as jax_make
    from graphical_gan_tpu_torch.train.step import make_train_step
    jm, tm, jp, tp = models(dataset, mode, seed=5, **extra)
    k = tm.cfg.critic_iters
    jstep, jinit = jax_make(jm, jit=True, donate=False)
    tstep, tinit = make_train_step(tm)
    js, ts = jinit(jp), tinit(tp)
    rng = np.random.default_rng(0)
    base = jax.random.PRNGKey(11)
    costs = []
    for it in range(iters):
        key = jax.random.fold_in(base, it)
        raw = raw_batch(tm.cfg, rng, lead=(1 + k,))
        per = [jax_draws(tm.cfg, jax.random.fold_in(key, j))
               for j in range(1 + k)]
        noise = {}
        for name in per[0]:
            rows = per[1:] if name in tm.DISC_ONLY_DRAWS else per
            if rows:
                noise[name] = torch.from_numpy(np.stack([r[name]
                                                         for r in rows]))
        js, jmet = jstep(js, jnp.asarray(raw), key, jnp.asarray(it > 0))
        ts, tmet = tstep(ts, torch.from_numpy(raw), it > 0, noise=noise)
        costs.append({n: (float(jmet[n]), float(tmet[n])) for n in tmet})
    return js, ts, costs


def check_states(js, ts, costs, k: int, iters: int = 3):
    """The port's state after the steps against JAX's. Costs to 1e-3 of
    max(1, |ref|). TF1 Adam's first steps move a parameter about lr·sign(g),
    so an element whose gradient is near 0 and differs in sign between the
    frameworks moves up to 2·lr_t the other way (lr_t < 1.3e-4 for every
    preset here): each parameter within 2.6e-4 per update of its player,
    each Adam moment leaf within 1e-2 of its largest element plus a floor
    of 1e-7 (m) and 1e-14 (v). A leaf whose m is rounding noise (at most
    1e-4 of its player's largest m: the biases before a BN, whose gradient
    is zero in exact arithmetic) is held to that noise level instead, and
    its v to the square."""
    for it, row in enumerate(costs):
        for name, (want, got) in row.items():
            assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), \
                (it, name, got, want)
    assert ts.step == int(js.step) == iters
    gen_updates = iters - 1
    for name, want in js.params.items():
        updates = k * iters if name.startswith("Discriminator") \
            else gen_updates
        d = float(np.abs(ts.params[name].numpy() - np.asarray(want)).max())
        assert d <= 2.6e-4 * max(updates, 1), (name, d)
    fields = ("gen_opt", "disc_opt") if k else ("gen_opt",)
    for field in fields:
        m_ref = getattr(js, field)["m"]
        top = max(float(np.abs(np.asarray(v)).max()) for v in m_ref.values())
        for slot in ("m", "v"):
            for name, want in getattr(js, field)[slot].items():
                got = getattr(ts, field)[slot][name].numpy()
                want = np.asarray(want)
                d = float(np.abs(got - want).max())
                # a leaf whose m is rounding noise (the biases before a BN:
                # gradient zero in exact arithmetic) may differ by noise of
                # 1e-4 of the player's largest m (its square for v)
                if float(np.abs(np.asarray(m_ref[name])).max()) <= 1e-4 * top:
                    noise = 1e-4 * top if slot == "m" else (1e-4 * top) ** 2
                    assert d <= noise, (field, slot, name, d, noise)
                    continue
                floor = 1e-7 if slot == "m" else 1e-14
                assert d <= 1e-2 * float(np.abs(want).max()) + floor, \
                    (field, slot, name, d)
    if not k:
        assert ts.disc_opt == {} and js.disc_opt == ()
