"""Shared helpers of the parallel parity tests (``test_torch_parallel_
*.py``): one case runs JAX's own mesh step (``graphical_gan_tpu.
parallel``) on the virtual CPU devices ``tests/conftest.py`` sets up, and
the port's one-process step, from the same parameters, global raw batches
and draws (the families' draw replays, ``_torch_family1``,
``_torch_gmgan``, ``_torch_ssgan``); :func:`payload` is what the gloo
ranks of ``_torch_dist.strategy_worker`` take for the port's parallel
step of the same case.

Tolerances, JAX's own criterion (``tests/test_parallel.py:52-61``): each
cost within rtol 2e-4, each parameter within 1.25·lr absolute per update
of its player (Adam's first steps move a parameter about lr·sign(g), and
a gradient near 0 may take the other sign in another summation order);
a leaf whose gradient is rounding noise may move the full 2·lr a flip
takes (``graphical_gan_tpu_torch/tools/parallel_check.py:
update_bound``, the rule the card's check holds too).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import _torch_family1 as f1
import _torch_gmgan as f2
import _torch_ssgan as f3

ITERS = 2
BASE = jax.random.PRNGKey(11)


def jax_mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(axes))


def _jax_factory(strategy, jm, mesh):
    from graphical_gan_tpu import parallel as jpar
    if strategy == "dp":
        return jpar.make_parallel_train_step(jm, mesh, donate=False)
    if strategy == "tp":
        return jpar.make_tp_train_step(jm, mesh, donate=False)
    if strategy == "sp":
        return jpar.make_sp_train_step(jm, mesh, donate=False)
    if strategy == "ep":
        return jpar.make_ep_train_step(jm, mesh, donate=False)
    return jpar.make_composed_train_step(
        jm, mesh, data_axis="data" if "data" in mesh.shape else None,
        seq_axis="seq" if "seq" in mesh.shape else None,
        model_axis="model" if "model" in mesh.shape else None,
        donate=False)


def _numpy_state(js):
    out = {f"params/{n}": np.asarray(p, np.float32)
           for n, p in js.params.items()}
    for field in ("gen_opt", "disc_opt"):
        for slot, v in dict(getattr(js, field) or {}).items():
            if isinstance(v, dict):
                for n, t in v.items():
                    out[f"{field}/{slot}/{n}"] = np.asarray(t, np.float32)
    return out


def prepare(family, dataset, mode, strategy, shape, axes, with_jax=True,
            **extra):
    """A case: the models, parameters, global raw batches and draws of
    :data:`ITERS` iterations, and the payload of the port's parallel run
    (``_torch_dist.strategy_worker``)."""
    lib = {"gan": f1, "gmgan": f2, "ssgan": f3}[family]
    if family == "gan":
        kw = f1.config_kw(dataset, **extra)
        jm, tm, jp, tp = f1.models(dataset, mode, seed=5, **extra)
    elif family == "gmgan":
        kw = f2.config_kw(dataset, **extra)
        jm, tm, jp, tp = f2.models(dataset, mode, seed=5, **extra)
    else:
        kw = f3.config_kw(**extra)
        jm, tm, jp, tp = f3.models(dataset, mode, seed=5, **extra)
    k = tm.cfg.critic_iters
    rng = np.random.default_rng(0)
    raws, noises, keys = [], [], []
    for it in range(ITERS):
        key = jax.random.fold_in(BASE, it)
        raws.append(f3.raw_batch(tm.cfg, rng, lead=(1 + k,))
                    if family == "ssgan"
                    else f1.raw_batch(tm.cfg, rng, lead=(1 + k,)))
        noise = _gan_noise(tm, key, k) if family == "gan" \
            else lib.step_noise(tm.cfg, key, k)
        noises.append({n: t.numpy() for n, t in noise.items()})
        keys.append(key)
    gen_spec, disc_spec = tm.opt_specs()
    return dict(
        models=(jm, tm, jp, tp), keys=keys, with_jax=with_jax,
        lr={"gen": gen_spec.lr, "disc": disc_spec.lr if disc_spec else 0.0},
        updates={"gen": ITERS - 1, "disc": k * ITERS},
        disc_prefix=tuple(tm.DISC_PLAYER),
        payload=dict(family=family, dataset=dataset, mode=mode, kw=kw,
                     strategy=strategy, shape=tuple(shape), axes=tuple(axes),
                     params={n: p.numpy() for n, p in tp.items()},
                     raws=raws, noises=noises))


def reference(case) -> None:
    """Adds to ``case`` the JAX mesh step's state and costs (``with_jax``;
    else the JAX columns repeat the port's) and the port's one-process
    step's, from the case's parameters, batches and draws."""
    from graphical_gan_tpu_torch.train.step import make_train_step
    from _torch_dist import _as_torch, state_numpy
    jm, tm, jp, tp = case["models"]
    pay = case["payload"]
    ssgan = pay["family"] == "ssgan"
    if case["with_jax"]:
        jstep, jinit, jplace = _jax_factory(
            pay["strategy"], jm, jax_mesh(pay["shape"], pay["axes"]))
        js = jplace(jinit(jp))
    tstep, tinit = make_train_step(tm)
    ts = tinit({n: p.clone() for n, p in tp.items()})
    costs, step = [], None
    for it, (raw, noise, key) in enumerate(zip(pay["raws"], pay["noises"],
                                               case["keys"])):
        traw = f3.as_torch(raw) if ssgan else torch.from_numpy(raw)
        ts, tmet = tstep(ts, traw, it > 0, noise=_as_torch(noise))
        if case["with_jax"]:
            # the step's output state comes in XLA's shardings; placed
            # again, every iteration runs the one compiled program
            js = jplace(js)
            jraw = f3.as_jax(raw) if ssgan else jnp.asarray(raw)
            args = (js, jraw, key, jnp.asarray(it > 0))
            if step is None:
                step = f2.compiled(jstep, *args)
            js, jmet = step(*args)
        else:
            jmet = tmet
        costs.append({n: (float(jmet[n]), float(tmet[n])) for n in tmet})
    port = state_numpy(ts)
    case.update(jax=_numpy_state(js) if case["with_jax"] else port,
                port=port, costs=costs)


def run_cases(cases, world: int):
    """The port's parallel runs of ``cases`` on ``world`` gloo ranks, the
    ranks running while the references are computed here; returns, per
    case, (case, the ranks' results)."""
    import _torch_dist
    job = _torch_dist.start("strategy_worker", world,
                            [c["payload"] for c in cases])
    for c in cases:
        reference(c)
    results = job.join()
    return [(c, [r[i] for r in results]) for i, c in enumerate(cases)]


def _gan_noise(tm, key, k):
    per = [f1.jax_draws(tm.cfg, jax.random.fold_in(key, j))
           for j in range(1 + k)]
    noise = {}
    for name in per[0]:
        rows = per[1:] if name in tm.DISC_ONLY_DRAWS else per
        if rows:
            noise[name] = torch.from_numpy(np.stack([r[name]
                                                     for r in rows]))
    return noise


def _bound(case, key, ref):
    """``parallel_check.update_bound`` of the parameter ``key`` against
    the ``ref`` state's Adam m (None for an optimizer leaf)."""
    from graphical_gan_tpu_torch.tools.parallel_check import update_bound
    if not key.startswith("params/"):
        return None
    name = key[len("params/"):]
    player = "disc" if name.startswith(case["disc_prefix"]) else "gen"
    field = "disc_opt" if player == "disc" else "gen_opt"
    ms = {k: v for k, v in case[ref].items() if k.startswith(field + "/m/")}
    top = max((float(np.abs(v).max()) for v in ms.values()), default=0.0)
    mine = ms.get(f"{field}/m/{name}")
    return update_bound(case["lr"][player], case["updates"][player],
                        None if mine is None else float(np.abs(mine).max()),
                        top)


def check_against(case, got_costs, got_state, ref="jax"):
    """The parallel run's costs and full state against JAX's mesh step
    (``ref`` "jax") or the port's one-process step ("port")."""
    idx = 0 if ref == "jax" else 1
    for it, row in enumerate(case["costs"]):
        for name, pair in row.items():
            want, got = pair[idx], got_costs[it][name]
            assert abs(got - want) <= 2e-4 * abs(want) + 1e-6, \
                (ref, it, name, got, want)
    want_state = case[ref]
    for key, want in want_state.items():
        bound = _bound(case, key, ref)
        if bound is None:
            continue
        got = got_state[key]
        assert got.shape == want.shape, (key, got.shape, want.shape)
        d = float(np.abs(got - want).max())
        assert d <= bound, (ref, key, d, bound)


def check_replicas(results):
    """Every rank's full state the same bits; a parameter no rank holds in
    slices the same bits on every rank."""
    first = results[0]
    for r in results[1:]:
        for key, v in first["full"].items():
            assert np.array_equal(v, r["full"][key]), ("full", key, r["rank"])
        for key, v in first["local"].items():
            name = key.split("/")[-1]
            if name in first["sharded"]:
                continue
            assert np.array_equal(v, r["local"][key]), ("local", key,
                                                        r["rank"])
