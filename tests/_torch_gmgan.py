"""Shared helpers of the GMGAN parity tests (``test_torch_gmgan*``): the
same parameters, raw batches and random draws through the JAX package's
``GMGanModel`` and the port's.

:func:`jax_draws` replays the JAX registry's stream (key n of one
``registry.apply`` is ``fold_in(key, 0x5EED0000 + n)``) in the JAX graph's
order (``graphical_gan_tpu_torch/models/gmgan.py``): celeba's
``dequant``, the Gumbel uniform ``gumbel_q`` of q(k|x), ``hyper_p_z`` and
``prior_idx`` of the prior, and ``gumbel_rec`` of q(k|E(G(p_z))), which no
cost reads but which takes its key all the same. Sizes: dim 8, B 4,
5 components (``config_kw``).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from graphical_gan_tpu.core import registry
from graphical_gan_tpu.core.config import gmgan_defaults as jax_cfg
from graphical_gan_tpu.models.gmgan import GMGanModel as JaxM
from graphical_gan_tpu_torch.core.config import gmgan_defaults
from graphical_gan_tpu_torch.models.gmgan import GMGanModel
from graphical_gan_tpu_torch.train.checkpoint import params_from_jax

from _torch_family1 import _Stream, close, close_grads, raw_batch, to_torch

B = 4
N_COMS = 5
GUMBEL = ("CONCRETE", "STRAIGHT_THROUGHT_CONCRETE")
# XLA's CPU backend at its lowest optimization level: the programs here run
# once or twice at dim 8, so their compile time is what the tests pay for
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def compiled(jitted, *args):
    """``jitted`` compiled for ``args`` with :data:`FAST`."""
    return jitted.lower(*args).compile(FAST)


def config_kw(dataset: str = "mnist", **extra) -> dict:
    kw = dict(dim=8, batch_size=B, n_coms=N_COMS)
    if dataset == "celeba":
        kw.update(dim_g=8, dim_d=8)
    kw.update(extra)
    return kw


def models(dataset: str, mode: str, mode_k: str = "CONCRETE", seed: int = 3,
           **extra):
    """(jax model, port model, jax params, port params): the port's init,
    handed to both."""
    kw = config_kw(dataset, mode_k=mode_k, **extra)
    jm = JaxM(jax_cfg(dataset, mode, **kw))
    tm = GMGanModel(gmgan_defaults(dataset, mode, **kw))
    np_params = {k: v.numpy() for k, v in tm.init(seed, "cpu").items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jm, tm, jp, params_from_jax(np_params, "cpu")


def jax_draws(cfg, key, batch: int = None) -> dict:
    """The draws one JAX ``gen_loss`` / ``disc_loss`` call makes under
    ``key``, by the port's names, as numpy arrays."""
    s = _Stream(key)
    batch = batch or cfg.batch_size
    out = {}
    if cfg.data.normalization == "dequant":
        out["dequant"] = jax.random.uniform(s.next(),
                                            (batch, cfg.data.output_dim))
    if cfg.mode_k in GUMBEL:
        out["gumbel_q"] = jax.random.uniform(s.next(), (batch, cfg.n_coms))
    out["hyper_p_z"] = jax.random.normal(s.next(), (batch, cfg.dim_latent))
    out["prior_idx"] = jax.random.randint(s.next(), (batch,), 0, cfg.n_coms)
    if cfg.mode_k in GUMBEL:
        out["gumbel_rec"] = jax.random.uniform(s.next(), (batch, cfg.n_coms))
    return {k: np.asarray(v) for k, v in out.items()}


def port_draws(cfg, key, batch: int = None) -> dict:
    """:func:`jax_draws` as the port takes them: ``gumbel_rec`` left out
    (the port never draws it)."""
    d = jax_draws(cfg, key, batch)
    d.pop("gumbel_rec", None)
    return to_torch(d)


@functools.lru_cache(maxsize=None)
def _jax_losses(dataset: str, mode: str, mode_k: str):
    """One jitted JAX function per config: both players' losses and their
    gradients w.r.t. their own parameters, from one trace of the JAX
    model's graph (``GMGanModel._graph`` and ``_costs``, what its
    ``gen_loss`` and ``disc_loss`` each run) and one VJP per loss."""
    jm = JaxM(jax_cfg(dataset, mode, **config_kw(dataset, mode_k=mode_k)))

    def both(params, raw, key):
        def losses(p):
            def costs():
                g, d, _ = jm._costs(jm._graph(raw))
                return g, d
            return registry.apply(costs, p, key)

        (g, d), vjp = jax.vjp(losses, params)
        (g_grads,) = vjp((jnp.ones_like(g), jnp.zeros_like(d)))
        (d_grads,) = vjp((jnp.zeros_like(g), jnp.ones_like(d)))
        return {"gen": (g, registry.partition(g_grads, jm.GEN_PLAYER)[0]),
                "disc": (d, registry.partition(d_grads,
                                               jm.DISC_PLAYER)[0])}

    return jax.jit(both)


@functools.lru_cache(maxsize=None)
def loss_case(dataset: str, mode: str, mode_k: str, seed: int = 0):
    """{player: (JAX loss, JAX grads, port loss, port grads)} of both
    players' losses from the same params, batch and draws; cached, so the
    gen and disc cases of one config share one JAX compile."""
    _, tm, jp, tp = models(dataset, mode, mode_k)
    raw = raw_batch(tm.cfg, np.random.default_rng(seed))
    key = jax.random.fold_in(jax.random.PRNGKey(7), seed)
    args = (jp, jnp.asarray(raw), key)
    ref = compiled(_jax_losses(dataset, mode, mode_k), *args)(*args)
    out = {}
    for player, names, fn in (("gen", tm.GEN_PLAYER, tm.gen_loss),
                              ("disc", tm.DISC_PLAYER, tm.disc_loss)):
        mine = {n: p.clone().requires_grad_(True) for n, p in tp.items()
                if any(s in n for s in names)}
        loss, _ = fn(dict(tp, **mine), torch.from_numpy(raw),
                     draws=port_draws(tm.cfg, key))
        grads = torch.autograd.grad(loss, list(mine.values()))
        j_loss, j_grads = ref[player]
        out[player] = (float(j_loss), j_grads, loss.detach(),
                       dict(zip(mine, grads)))
    return out


def check_losses(dataset: str, mode: str, mode_k: str, player: str):
    """One player's loss to atol 1e-4 of max(1, |ref|) and its gradients
    per leaf (``_torch_family1.close_grads``)."""
    j_loss, j_grads, t_loss, t_grads = loss_case(dataset, mode,
                                                 mode_k)[player]
    close(t_loss, j_loss)
    close_grads(t_grads, j_grads)


def step_noise(cfg, key, k: int, accum: int = 1) -> dict:
    """The port's ``noise`` for one iteration of the JAX step under
    ``key``: update j draws under ``fold_in(key, j)``, microbatch m of it
    (``accum`` > 1) under ``fold_in(fold_in(key, j), m)``, as JAX's
    ``accumulate_value_and_grad`` folds the update's key."""
    per = []
    for j in range(1 + k):
        uk = jax.random.fold_in(key, j)
        if accum == 1:
            per.append(port_draws(cfg, uk))
            continue
        micro = [port_draws(cfg, jax.random.fold_in(uk, m),
                            cfg.batch_size // accum)
                 for m in range(accum)]
        per.append({n: torch.stack([d[n] for d in micro]) for n in micro[0]})
    return {n: torch.stack([d[n] for d in per]) for n in per[0]}


def run_steps(dataset: str, mode: str, mode_k: str = "CONCRETE",
              iters: int = 2, accum: int = 1, **extra):
    """(JAX state, port state, per-iteration (JAX, port) costs) after
    ``iters`` iterations of the JAX ``make_train_step`` and the port's from
    the same params, batches and draws (:func:`step_noise`). With
    ``accum`` > 1 the iteration-0 G cost (not an update) is left out of
    the costs: the port averages it over the microbatches, JAX evaluates
    the whole batch once."""
    from graphical_gan_tpu.train.step import make_train_step as jax_make
    from graphical_gan_tpu_torch.train.step import make_train_step
    if accum > 1:
        extra["accum_steps"] = accum
    jm, tm, jp, tp = models(dataset, mode, mode_k, seed=5, **extra)
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
        args = (js, jnp.asarray(raw), key, jnp.asarray(it > 0))
        if step is None:
            step = compiled(jstep, *args)
        js, jmet = step(*args)
        ts, tmet = tstep(ts, torch.from_numpy(raw), it > 0,
                         noise=step_noise(tm.cfg, key, k, accum))
        costs.append({n: (float(jmet[n]), float(tmet[n])) for n in tmet
                      if accum == 1 or it > 0 or n != "gen_cost"})
    return js, ts, costs
