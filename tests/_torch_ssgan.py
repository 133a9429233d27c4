"""Shared helpers of the SSGAN parity tests (``test_torch_ssgan_*``): the
same parameters, raw batches and random draws through the JAX package's
``SSGanModel`` and the port's.

:func:`jax_draws` replays the JAX registry's stream (key n of one
``registry.apply`` is ``fold_in(key, 0x5EED0000 + n)``) in the JAX graph's
order (``graphical_gan_tpu_torch/models/ssgan.py``): ``p_z_l_0``, the
prior chain's one ``epsilon``, ``p_z_g`` and, conditional only, ``p_y``.
Sizes are the JAX tests' (``tests/test_ssgan.py``): dim 4, dim_op 16,
B 2, 64x64 frames, LEN 3 or 4 (:func:`config_kw`). Each JAX graph is
traced once for both players and compiled at XLA's lowest optimization
level (``_torch_gmgan.FAST``).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import ssgan_defaults as jax_cfg
from graphical_gan_tpu.models.ssgan import SSGanModel as JaxM
from graphical_gan_tpu_torch.core.config import ssgan_defaults
from graphical_gan_tpu_torch.models.ssgan import SSGanModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax

from _torch_family1 import _Stream, close, to_torch
from _torch_gmgan import compiled

B = 2


def config_kw(**extra) -> dict:
    kw = dict(dim=4, dim_op=16, batch_size=B, seq_len=4, image_hw=(64, 64))
    kw.update(extra)
    return kw


def models(dataset: str, mode: str, seed: int = 3, **extra):
    """(jax model, port model, jax params, port params): the port's init,
    handed to both."""
    kw = config_kw(**extra)
    jm = JaxM(jax_cfg(dataset, mode, **kw))
    tm = SSGanModel(ssgan_defaults(dataset, mode, **kw))
    np_params = {k: v.numpy() for k, v in tm.init(seed, "cpu").items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jm, tm, jp, params_from_jax(np_params, "cpu")


def raw_batch(cfg, rng: np.random.Generator, lead=()):
    """A raw batch as the loaders give it: moving-MNIST ``{'x': videos in
    [0, 1], 'y': one-hot labels}``, chairs integer pixels as f32."""
    shape = tuple(lead) + (cfg.batch_size, cfg.seq_len, cfg.output_dim)
    if cfg.dataset == "chairs":
        return rng.integers(0, 256, shape).astype(np.float32)
    y = np.eye(cfg.n_classes, dtype=np.float32)[
        rng.integers(0, cfg.n_classes, tuple(lead) + (cfg.batch_size,))]
    return {"x": rng.random(shape, dtype=np.float32), "y": y}


def as_jax(raw):
    return jax.tree.map(jnp.asarray, raw)


def as_torch(raw):
    if isinstance(raw, dict):
        return {k: torch.from_numpy(v) for k, v in raw.items()}
    return torch.from_numpy(raw)


def jax_draws(cfg, key, batch: int = None) -> dict:
    """The draws one JAX ``gen_loss`` / ``disc_loss`` call makes under
    ``key``, by the port's names, as numpy arrays."""
    s = _Stream(key)
    batch = batch or cfg.batch_size
    cdt = jnp.dtype(cfg.compute_dtype)
    out = {"p_z_l_0": jax.random.normal(s.next(), (batch, cfg.dim_latent_l),
                                        cdt),
           "epsilon": jax.random.normal(s.next(),
                                        (batch, cfg.dim_latent_t), cdt),
           "p_z_g": jax.random.normal(s.next(), (batch, cfg.dim_latent_g),
                                      cdt)}
    if cfg.conditional:
        out["p_y"] = jax.random.randint(s.next(), (batch,), 0,
                                        cfg.n_classes)
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v) for k, v in out.items()}


def _split(raw):
    if isinstance(raw, dict):
        return raw["x"], raw["y"]
    return raw, None


@functools.lru_cache(maxsize=None)
def _jax_losses(dataset: str, mode: str, extra: tuple):
    """One jitted JAX function per config: both players' losses and their
    gradients w.r.t. their own parameters, from one trace of the JAX
    model's graph (``SSGanModel._graph`` and ``_costs``, what its
    ``gen_loss`` and ``disc_loss`` each run) and one VJP per loss."""
    jm = JaxM(jax_cfg(dataset, mode, **config_kw(**dict(extra))))

    def both(params, raw, key):
        def losses(p):
            def costs():
                g, d, _ = jm._costs(jm._graph(*_split(raw)))
                return g, d
            return registry.apply(costs, p, key)

        (g, d), vjp = jax.vjp(losses, params)
        (g_grads,) = vjp((jnp.ones_like(g), jnp.zeros_like(d)))
        (d_grads,) = vjp((jnp.zeros_like(g), jnp.ones_like(d)))
        return {"gen": (g, registry.partition(g_grads, jm.GEN_PLAYER)[0]),
                "disc": (d, registry.partition(d_grads,
                                               jm.DISC_PLAYER)[0])}

    return jax.jit(both)


def _port_grads(tm, params, raw, draws, player):
    names = tm.GEN_PLAYER if player == "gen" else tm.DISC_PLAYER
    fn = tm.gen_loss if player == "gen" else tm.disc_loss
    mine = {n: p.clone().requires_grad_(True) for n, p in params.items()
            if any(s in n for s in names)}
    loss, _ = fn(dict(params, **mine), as_torch(raw), draws=draws)
    grads = torch.autograd.grad(loss, list(mine.values()))
    return loss.detach(), dict(zip(mine, grads))


@functools.lru_cache(maxsize=None)
def loss_case(dataset: str, mode: str, extra: tuple = (), seed: int = 0):
    """{player: (JAX loss, JAX grads, port loss, port grads, port grads at
    parameters moved by one f32 rounding)} of both players' losses from the
    same params, batch and draws; cached, so the gen and disc cases of one
    config share one JAX compile. ``extra`` is a tuple of config overrides
    ((name, value), ...). The last entry is computed when first asked
    for."""
    _, tm, jp, tp = models(dataset, mode, **dict(extra))
    raw = raw_batch(tm.cfg, np.random.default_rng(seed))
    key = jax.random.fold_in(jax.random.PRNGKey(7), seed)
    args = (jp, as_jax(raw), key)
    ref = compiled(_jax_losses(dataset, mode, extra), *args)(*args)
    draws = to_torch(jax_draws(tm.cfg, key))
    out = {}
    for player in ("gen", "disc"):
        loss, grads = _port_grads(tm, tp, raw, draws, player)
        j_loss, j_grads = ref[player]

        @functools.lru_cache(maxsize=None)
        def moved(player=player):
            g = torch.Generator().manual_seed(seed)
            pert = {n: p * (1 + ULP * torch.randn(p.shape, generator=g))
                    for n, p in tp.items()}
            return _port_grads(tm, pert, raw, draws, player)[1]

        out[player] = (float(j_loss), j_grads, loss, grads, moved)
    return out


# a bias right before a batch-statistics BN has gradient 0 in exact
# arithmetic: both frameworks give rounding noise there, each side held to
# this fraction of the player's largest gradient element
PRE_BN_NOISE = 1e-5
# one f32 rounding, relative: the parameters' move of the conditioning check
ULP = 2.0 ** -24
# the most a leaf may exceed its bound by where the conditioning check lets
# it pass, as a multiple of the bound
KINK_CAP = 10.0
# the only (dataset, mode, overrides, player) that may use the
# conditioning check, and its leaves: moving-MNIST local_epce-z inverse
# with BN, whose G leaves differ from JAX's by 1.02-3.15x their bound
# while the port's own gradient moves as far under a 1-ulp parameter move
KINK_LEAVES = {
    ("moving_mnist", "local_epce-z",
     (("pos_mode", "inverse"), ("seq_len", 4), ("bn", True)), "gen"):
    frozenset({"Extractor.2.Filters", "Extractor.BN2.scale",
               "Extractor.Dynamic.Backward.Output.W", "Extractor.G.1.Biases",
               "Extractor.G.2.Filters", "Extractor.G.BN2.scale",
               "Generator.2.Filters", "Generator.3.Filters",
               "Generator.BN3.offset"}),
}


def pre_bn_biases(cfg) -> set:
    """The biases that feed a batch-statistics BN directly (none without
    BN): G's input layer and the convs 2-4 of every conv stack and G."""
    if not cfg.bn:
        return set()
    out = {"Generator.Input.b"}
    for prefix in ("Extractor.", "Extractor.G.", "Generator.",
                   "Discriminator."):
        out |= {f"{prefix}{i}.Biases" for i in (2, 3, 4)}
    return out


def check_losses(dataset: str, mode: str, extra: tuple, player: str):
    """One player's loss to atol 1e-4 of max(1, |ref|) and its gradients
    per leaf to 1e-4 of max(1e-2, the leaf's largest, 1e-2 of the player's
    largest), as ``_torch_family1.close_grads`` holds them; the biases
    before a BN (:func:`pre_bn_biases`) to :data:`PRE_BN_NOISE` of the
    player's largest on each side. A leaf over its bound passes only if it
    is one of :data:`KINK_LEAVES`, stays within :data:`KINK_CAP` times its
    bound, and the port's own gradient moves at least half as far when
    every parameter moves by one f32 rounding (:data:`ULP`, relative): an
    activation within rounding of its kink, where the gradient is not
    determined to more digits by either framework. Each such pass is
    printed."""
    j_loss, j_grads, t_loss, t_grads, moved = loss_case(
        dataset, mode, extra)[player]
    close(t_loss, j_loss)
    cfg = ssgan_defaults(dataset, mode, **config_kw(**dict(extra)))
    assert set(t_grads) == set(j_grads), set(t_grads) ^ set(j_grads)
    top = max(float(np.abs(np.asarray(v)).max()) for v in j_grads.values())
    noise = pre_bn_biases(cfg) & set(j_grads)
    for name in sorted(j_grads):
        ref = np.asarray(j_grads[name])
        got = t_grads[name].numpy()
        if name in noise:
            for side in (ref, got):
                assert float(np.abs(side).max()) <= PRE_BN_NOISE * top, name
            continue
        d = float(np.abs(got - ref).max())
        bound = 1e-4 * max(1e-2, float(np.abs(ref).max()), 1e-2 * top)
        if d > bound:
            named = KINK_LEAVES.get((dataset, mode, tuple(extra), player),
                                    frozenset())
            swing = float((moved()[name] - t_grads[name]).abs().max())
            assert name in named and d <= KINK_CAP * bound, (name, d, bound)
            assert d <= bound + 2.0 * swing, (name, d, bound, swing)
            print(f"kink allowance: {dataset} {mode} {extra} {player} "
                  f"{name}: {d / bound:.3f} x its bound, 1-ulp swing "
                  f"{swing / bound:.3f} x")


def step_noise(cfg, key, k: int, accum: int = 1) -> dict:
    """The port's ``noise`` for one iteration of the JAX step under
    ``key``: update j draws under ``fold_in(key, j)``, microbatch m of it
    (``accum`` > 1) under ``fold_in(fold_in(key, j), m)``."""
    per = []
    for j in range(1 + k):
        uk = jax.random.fold_in(key, j)
        if accum == 1:
            per.append(to_torch(jax_draws(cfg, uk)))
            continue
        micro = [to_torch(jax_draws(cfg, jax.random.fold_in(uk, m),
                                    cfg.batch_size // accum))
                 for m in range(accum)]
        per.append({n: torch.stack([d[n] for d in micro]) for n in micro[0]})
    return {n: torch.stack([d[n] for d in per]) for n in per[0]}


def run_steps(dataset: str, mode: str, iters: int = 2, accum: int = 1,
              **extra):
    """(JAX state, port state, per-iteration (JAX, port) costs) after
    ``iters`` iterations of the JAX ``make_train_step`` and the port's from
    the same params, raw batches (dicts for moving-MNIST) and draws. With
    ``accum`` > 1 the iteration-0 G cost is left out (the port averages it
    over the microbatches, JAX evaluates the whole batch once)."""
    from graphical_gan_tpu.train.step import make_train_step as jax_make
    from graphical_gan_tpu_torch.train.step import make_train_step
    if accum > 1:
        extra["accum_steps"] = accum
    jm, tm, jp, tp = models(dataset, mode, seed=5, **extra)
    k = tm.cfg.critic_iters
    jstep, jinit = jax_make(jm, jit=True, donate=False)
    tstep, tinit = make_train_step(tm)
    js, ts = jinit(jp), tinit(tp)
    rng = np.random.default_rng(0)
    base = jax.random.PRNGKey(11)
    costs, step = [], None
    for it in range(iters):
        key = jax.random.fold_in(base, it)
        raw = raw_batch(tm.cfg, rng, lead=(1 + k,))
        args = (js, as_jax(raw), key, jnp.asarray(it > 0))
        if step is None:
            step = compiled(jstep, *args)
        js, jmet = step(*args)
        ts, tmet = tstep(ts, as_torch(raw), it > 0,
                         noise=step_noise(tm.cfg, key, k, accum))
        costs.append({n: (float(jmet[n]), float(tmet[n])) for n in tmet
                      if accum == 1 or it > 0 or n != "gen_cost"})
    return js, ts, costs


POS_MODES = ("naive_mean_field", "inverse", "forward_inverse", "gsp")


def cases(plan, ali_mode=None):
    """(dataset, mode, overrides) per (mode, pos_mode) of ``plan``, the
    other factors turned with the case's index i: moving-MNIST
    (conditional, ``res``) at even i and chairs (unconditional, ``res_w``)
    at odd i; LEN 4 at even i and 3 at odd i (the 3dcnn's temporal strides
    1 and 2); BN on at i = 1 and 2."""
    out = []
    for i, (mode, pos) in enumerate(plan):
        extra = [("pos_mode", pos), ("seq_len", 3 if i % 2 else 4),
                 ("bn", i in (1, 2))]
        if ali_mode is not None:
            extra.append(("ali_mode", ali_mode))
        out.append(("chairs" if i % 2 else "moving_mnist", mode,
                    tuple(extra)))
    return out


def case_id(case) -> str:
    dataset, mode, extra = case
    return "-".join([dataset, mode] + [f"{k}={v}" for k, v in extra])
