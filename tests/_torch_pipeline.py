"""Shared helpers of the pipeline parity tests (``test_torch_pipeline_
*.py``): the JAX package's pipeline (``graphical_gan_tpu/parallel/
pipeline.py``) and the port's (``graphical_gan_tpu_torch/parallel/
pipeline.py``) from the same parameters, raw batches and draws.

JAX's pipeline draws each (update, stage, microbatch)'s numbers from
``_stage_key(update key, stage, microbatch)``, key n of a stage being
``fold_in(stage key, 0x5EED0000 + n)`` (the registry's stream, replayed
by ``_torch_family1._Stream``). :func:`pp_noise` replays them in the
stage functions' order and hands them to the port by name, stacked
[update, microbatch, rows, ...] as the port's step takes them; the
update keys are ``fold_in(key, 0)`` for the G update and
``fold_in(key, 1 + i)`` for D update i, as JAX's ``make_pp_train_step``
folds them. Sizes: dim 8, B 8, M 2 microbatches.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import _torch_family1 as f1
import _torch_gmgan as f2

ITERS = 2
M = 2
B = 8
BASE = jax.random.PRNGKey(11)


def models(family: str, dataset: str, mode: str, seed: int = 5, **extra):
    """(jax model, port model, jax params, port params) at B = 8."""
    lib = f1 if family == "gan" else f2
    return lib.models(dataset, mode, seed=seed, batch_size=B, **extra)


def _stochastic(cfg) -> bool:
    return cfg.type_q in ("learn_std", "fix_std") and cfg.dataset != "celeba"


def stage_draws(cfg, key, stage: int, n_stages: int, rows: int) -> dict:
    """The draws JAX's stage function ``stage`` makes under its key, by
    the port's names, as numpy arrays."""
    s = f1._Stream(key)
    out = {}
    gmgan = hasattr(cfg, "n_coms")
    z = cfg.dim_latent
    if stage == 0 and cfg.data.normalization == "dequant":
        out["dequant"] = jax.random.uniform(s.next(),
                                            (rows, cfg.data.output_dim))
    if gmgan and stage == 0:
        if cfg.mode_k in f2.GUMBEL:
            out["gumbel_q"] = jax.random.uniform(s.next(),
                                                 (rows, cfg.n_coms))
        out["hyper_p_z"] = jax.random.normal(s.next(), (rows, z))
        out["prior_idx"] = jax.random.randint(s.next(), (rows,), 0,
                                              cfg.n_coms)
    elif not gmgan and stage == {2: 0, 4: 1}[n_stages]:
        # the stage of E's head and G
        if _stochastic(cfg):
            out["eps_q"] = jax.random.normal(s.next(), (rows, z))
        out["p_z"] = jax.random.normal(s.next(), (rows, z),
                                       jnp.dtype(cfg.compute_dtype))
    elif not gmgan and stage == n_stages - 1 and cfg.mode == "wali-gp":
        out["alpha"] = jax.random.uniform(s.next(), (rows, 1))
    return {k: np.asarray(v) for k, v in out.items()}


def pp_noise(tm, key, n_stages: int, microbatches: int = M) -> dict:
    """The port's ``noise`` for one iteration of JAX's pp step under
    ``key``: name -> [1+k, M, B/M, ...] ([k, ...] for the draws only a D
    update makes)."""
    from graphical_gan_tpu.parallel.pipeline import _stage_key
    cfg = tm.cfg
    k = cfg.critic_iters
    rows = cfg.batch_size // microbatches
    per = []
    for u in range(1 + k):
        uk = jax.random.fold_in(key, u)
        mbs = []
        for j in range(microbatches):
            d = {}
            for s in range(n_stages):
                d.update(stage_draws(cfg, _stage_key(uk, s, j), s, n_stages,
                                     rows))
            mbs.append(d)
        per.append({n: np.stack([d[n] for d in mbs]) for n in mbs[0]})
    out = {}
    for name in per[0]:
        ups = per[1:] if name in tm.DISC_ONLY_DRAWS else per
        if ups:
            out[name] = torch.from_numpy(np.stack([p[name] for p in ups]))
    return out


def jax_mesh(n: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n]), ("stage",))


def state_numpy(model, state, n_stages: int) -> dict:
    """A pp state (JAX's or the port's, full) as
    ``params/<name>``, ``<gen_opt|disc_opt>/<m|v>/<name>`` and ``t``."""
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    stages = pp.normalized_stages(model, n_stages)
    arr = {f: np.asarray(state[f], np.float32) for f in ("packed", "m", "v")}
    out = {"t": np.asarray(state["t"]).astype(np.int64)}
    for r, tmpl in enumerate(stages.templates):
        field = "gen_opt" if r in stages.gen_rows else "disc_opt"
        for n, shape, off, size in tmpl.entries:
            out[f"params/{n}"] = arr["packed"][r, off:off + size] \
                .reshape(shape)
            for slot in ("m", "v"):
                out[f"{field}/{slot}/{n}"] = arr[slot][r, off:off + size] \
                    .reshape(shape)
    return out


def prepare(family: str, dataset: str, mode: str, n_stages: int,
            **extra) -> dict:
    """A case: models, parameters, the global raw batches and draws of
    :data:`ITERS` iterations, and the payload of the port's ranks
    (``_torch_dist.pipeline_worker``)."""
    lib = f1 if family == "gan" else f2
    jm, tm, jp, tp = models(family, dataset, mode, **extra)
    k = tm.cfg.critic_iters
    rng = np.random.default_rng(0)
    raws, noises, keys = [], [], []
    for it in range(ITERS):
        key = jax.random.fold_in(BASE, it)
        raws.append(f1.raw_batch(tm.cfg, rng, lead=(1 + k,)))
        noises.append({n: t.numpy() for n, t in
                       pp_noise(tm, key, n_stages).items()})
        keys.append(key)
    gen_spec, disc_spec = tm.opt_specs()
    kw = lib.config_kw(dataset, batch_size=B, **extra)
    return dict(
        models=(jm, tm, jp, tp), keys=keys, n_stages=n_stages,
        lr={"gen": gen_spec.lr, "disc": disc_spec.lr},
        updates={"gen": ITERS - 1, "disc": k * ITERS},
        disc_prefix=tuple(tm.DISC_PLAYER),
        payload=dict(family=family, dataset=dataset, mode=mode, kw=kw,
                     n_stages=n_stages, microbatches=M,
                     params={n: p.numpy() for n, p in tp.items()},
                     raws=raws, noises=noises))


def reference(case, with_jax: bool = True) -> None:
    """Adds to ``case`` JAX's ``make_pp_train_step`` on the virtual
    devices (``with_jax``; else the JAX columns repeat the port's) and
    the port's one-process staged step (``make_staged_reference_step``):
    states and costs."""
    from graphical_gan_tpu.parallel import pipeline as jpp
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    from _torch_dist import _as_torch
    jm, tm, jp, tp = case["models"]
    pay = case["payload"]
    n = pay["n_stages"]
    # the JAX cut reads only the names and shapes of model.init's
    # parameters: hand it these, not a new eager init per call
    jm.init = lambda key: jp
    if with_jax:
        jstep, jinit, jplace, _ = jpp.make_pp_train_step(
            jm, jax_mesh(n), microbatches=M, donate=False, n_stages=n)
        js = jplace(jinit(jp))
    tstep, tinit = pp.make_staged_reference_step(tm, microbatches=M,
                                                 n_stages=n)
    ts = tinit({k: v.clone() for k, v in tp.items()})
    costs, step = [], None
    for it, (raw, noise, key) in enumerate(zip(pay["raws"], pay["noises"],
                                               case["keys"])):
        ts, tmet = tstep(ts, torch.from_numpy(raw), it > 0,
                         noise=_as_torch(noise))
        if with_jax:
            js = jplace(js)
            args = (js, jnp.asarray(raw), key, jnp.asarray(it > 0))
            if step is None:
                step = f2.compiled(jstep, *args)
            js, jmet = step(*args)
        else:
            jmet = tmet
        costs.append({m: (float(jmet[m]), float(tmet[m])) for m in tmet})
    port = state_numpy(tm, ts, n)
    case.update(jax=state_numpy(tm, js, n) if with_jax else port, port=port,
                costs=costs)


def check_against(case, got_costs, got_state, ref="jax") -> None:
    """Costs within rtol 2e-4 and each parameter within
    ``parallel_check.update_bound`` (``_torch_parallel.check_against``),
    and the rows' step counts exactly: each player's rows counted its own
    updates only."""
    import _torch_parallel
    _torch_parallel.check_against(case, got_costs, got_state, ref)
    np.testing.assert_array_equal(got_state["t"], case[ref]["t"])
    _, tm, _, _ = case["models"]
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    stages = pp.normalized_stages(tm, case["n_stages"])
    want = [case["updates"]["gen" if r in stages.gen_rows else "disc"]
            for r in range(stages.n)]
    assert list(got_state["t"]) == want, (list(got_state["t"]), want)


def staged_noise(tm, key, n_stages: int, microbatches: int = M) -> dict:
    """The draws of JAX's ``sequential_staged_losses`` under ``key`` as
    the port's ``noise`` of a G update (index 0) and a D update (index
    1): every stage's stream under ``_stage_key(key, stage, j)``."""
    from graphical_gan_tpu.parallel.pipeline import _stage_key
    rows = tm.cfg.batch_size // microbatches
    mbs = []
    for j in range(microbatches):
        d = {}
        for s in range(n_stages):
            d.update(stage_draws(tm.cfg, _stage_key(key, s, j), s, n_stages,
                                 rows))
        mbs.append(d)
    out = {}
    for name in mbs[0]:
        t = torch.from_numpy(np.stack([d[name] for d in mbs]))
        out[name] = t[None] if name in tm.DISC_ONLY_DRAWS \
            else torch.stack([t, t])
    return out


def check_staged_losses(family: str, dataset: str, mode: str,
                        n_stages: int, **extra) -> None:
    """Both players' staged costs and their gradients w.r.t. their own
    parameters, port against JAX's ``sequential_staged_losses`` (one
    jitted VJP per case): costs to atol 1e-4 of max(1, |ref|), gradients
    per ``_torch_family1.close_grads``."""
    from graphical_gan_tpu.core import registry
    from graphical_gan_tpu.parallel import pipeline as jpp
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    jm, tm, jp, tp = models(family, dataset, mode, **extra)
    jm.init = lambda key: jp  # the JAX cut reads names and shapes only
    raw = f1.raw_batch(tm.cfg, np.random.default_rng(3))
    key = jax.random.PRNGKey(13)

    def both(params, r, k):
        (g, d), vjp = jax.vjp(
            lambda p: jpp.sequential_staged_losses(jm, p, r, k, M, n_stages),
            params)
        (g_grads,) = vjp((jnp.ones_like(g), jnp.zeros_like(d)))
        (d_grads,) = vjp((jnp.zeros_like(g), jnp.ones_like(d)))
        return g, d, g_grads, d_grads

    args = (jp, jnp.asarray(raw), key)
    jg, jd, jgg, jdg = f2.compiled(jax.jit(both), *args)(*args)
    noise = staged_noise(tm, key, n_stages)
    for player, names, j_loss, j_grads, u in (
            ("gen", tm.GEN_PLAYER, jg, jgg, 0),
            ("disc", tm.DISC_PLAYER, jd, jdg, 1)):
        leaves = {n: p.clone().requires_grad_(any(s in n for s in names))
                  for n, p in tp.items()}
        loss = pp.sequential_staged_losses(
            tm, leaves, torch.from_numpy(raw), M, n_stages, noise=noise,
            update=u, player=player)
        mine = [n for n in leaves if leaves[n].requires_grad]
        grads = torch.autograd.grad(loss, [leaves[n] for n in mine])
        f1.close(loss.detach(), float(j_loss))
        f1.close_grads(dict(zip(mine, grads)),
                       registry.partition(j_grads, names)[0])


def run_cases(cases, world: int, with_jax=None):
    """The port's pipeline runs of ``cases`` on ``world`` gloo ranks
    while the references are computed here (``with_jax[i]`` for case i,
    default all); per case, (case, the ranks' results), each rank's full
    state as :func:`state_numpy`."""
    import _torch_dist
    job = _torch_dist.start("pipeline_worker", world,
                            [c["payload"] for c in cases])
    for i, c in enumerate(cases):
        reference(c, True if with_jax is None else with_jax[i])
    results = job.join()
    out = []
    for i, c in enumerate(cases):
        ranks = [r[i] for r in results]
        for r in ranks:
            r["state"] = state_numpy(c["models"][1], r["full"],
                                     c["n_stages"])
        out.append((c, ranks))
    return out


def check_ranks(case, ranks) -> None:
    """Each rank held one row of the packed state, all ranks gathered the
    same full state and costs, and ``read_params`` saw every parameter."""
    n = case["n_stages"]
    first = ranks[0]
    _, tm, _, tp = case["models"]
    assert len(ranks) == n
    for r in ranks:
        assert r["row"][0] == 1, r["row"]
        assert r["costs"] == first["costs"]
        assert r["n_params"] == sum(p.numel() for p in tp.values())
        for f in ("packed", "m", "v", "t"):
            assert np.array_equal(r["full"][f], first["full"][f]), f
