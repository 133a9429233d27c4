"""The parallel strategies (``graphical_gan_tpu_torch/parallel``) on one
machine, each against the one-device step.

    python -m graphical_gan_tpu_torch.tools.parallel_check \\
        [--ranks 2] [--device cpu] [--small] [--out FILE]

Two runs, each in processes of its own (the library must be built first,
so the ranks load it and none builds it):

1. ``world1``: one process, a process group of one rank (NCCL on the
   card, gloo on the CPU); each of dp, tp, sp, ep and composed at mesh
   size 1 trains 2 iterations in f32 and must equal the one-device step
   (``train/step.py: make_train_step``) from the same parameters, batches
   and seeds bit for bit: costs, parameters and Adam moments;
2. ``ranks``: ``--ranks`` processes in one gloo group, all on ``cuda:0``
   (NCCL refuses two ranks on one device) or on the CPU: dp and tp on
   cifar10 wali-gp, ep on GMGAN mnist local_ep and sp on SSGAN
   moving-MNIST local_ep (with BN, so the frame networks' BNs run the
   split kernels), at the published widths (``--small``: a narrow width
   for the CPU), 2 iterations each at the global batch, held to the
   one-device step on rank 0 (costs within rtol 2e-4, each parameter
   within 1.25·lr per update of its player, 2·lr where the reference's
   Adam m is rounding noise, and past that only sign flips of Adam's
   first steps at small gradients, whose m differs from the reference's
   by at most FLIP_M_SHARE of the leaf's largest, ``_misses``) and the
   replicas bit-identical across ranks
   (every replicated leaf, and every rank's gathered state). The ranks'
   launch counts (set to 0 just before the strategies run: every split
   kernel launched, as many ``bn_stats_local`` as ``bn_apply_split`` and
   as many ``bn_bwd_local`` as ``bn_bwd_apply_split``) and which
   collectives gloo takes on the ranks' tensors (``all_gather``,
   ``reduce_scatter``, ``all_to_all``, ``barrier``) are reported. Then dp
   trains through the ``Trainer``'s chunked loop (``train/trainer.py``)
   for CHUNK_ITERS iterations on resident data at ``chunk_size`` 2 and 1:
   the full states must be equal bit for bit (``chunk_bit_identical``).

   In both runs the tp strategy also saves its state mid-run through the
   sharded checkpoint backend (``train/checkpoint_orbax.py``: each rank
   writes its slices), restores and places it, and the resumed iteration
   must equal the uninterrupted one bit for bit
   (``sharded_resume_bit_identical``);
3. ``pp``: 2 gloo ranks on ``cuda:0``, one pipeline stage each
   (``parallel/pipeline.py``, 4 microbatches, GMGAN's batch of 50 in 5):
   cifar10 wali-gp and GMGAN mnist local_ep at the published widths, 2
   iterations, held to the
   one-process staged step (``make_staged_reference_step``) as the
   strategies of run 2 are held to theirs; each rank's launches (set to
   0 just before the pipelines run), the seconds of the 2 iterations and
   of 2 more (warm) and each rank's bubble share in both (the seconds it
   waited at its boundaries over its steps' seconds, beside GPipe's
   (S-1)/(M+S-1)). Rank 0 also
   converts the one-device step's state to the packed state and back,
   and a packed state to the standard one and back: bit for bit
   (``migration``);
4. ``pp4``: the same on 4 gloo ranks, the 4-stage cut of cifar10 ali;
5. ``serve``: the server's ``--dp-devices 2`` (``serve/server.py:
   DataParallelEntry``) on 2 gloo ranks on ``cuda:0``, a cifar10 wali-gp
   run directory at the published width: one bucket-64 dispatch, float
   and int8, against the one-rank server's (float within DP_SERVE_ATOL;
   int8 within it at all but DP_SERVE_INT8_SHARE of the elements, where
   a merged statistic may move a value across an int8 rounding step),
   rank 0's launches of the dispatch (the split forward: as many
   ``bn_stats_local`` launches as ``bn_apply_split`` and its int8 form's
   together, no one-launch K2a or K2b) and both servers' ms per dispatch.

Each run prints one JSON line; ``--out`` also writes them as one JSON
document; ``--runs`` picks runs (default all). Exits nonzero if a check
fails. Runs on ``cuda`` unless ``--device cpu``; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (strategy, family, dataset, mode, mesh axes at ``ranks`` ranks; the
# strategy's axis takes the ranks)
RANK_CASES = (("dp", "gan", "cifar10", "wali-gp", ("data",)),
              ("tp", "gan", "cifar10", "wali-gp", ("data", "model")),
              ("ep", "gmgan", "mnist", "local_ep", ("data", "expert")),
              ("sp", "ssgan", "moving_mnist", "local_ep", ("data", "seq")))
WORLD1_CASES = RANK_CASES + (
    ("composed", "gan", "cifar10", "wali-gp", ("data", "model")),)
ITERS = 2
# the dp Trainer's chunk check: iterations 0-4 alone, then 5-6 in one
# dispatch at chunk_size 2
CHUNK_ITERS = 7
# the pipeline's cases (family, dataset, mode) per stage count, and its
# microbatches
PP_CASES = {2: (("gan", "cifar10", "wali-gp"), ("gmgan", "mnist",
                                                 "local_ep")),
            4: (("gan", "cifar10", "ali"),)}
MICROBATCHES = (4, 5, 2)


def microbatches(batch_size: int) -> int:
    """The pipeline's microbatch count: 4 (JAX's default) where it divides
    the batch, else the first of 5 and 2 that does (GMGAN mnist's
    published batch is 50)."""
    return next((m for m in MICROBATCHES if batch_size % m == 0), 1)
RUNS = ("world1", "ranks", "pp", "pp4", "serve")
# the dp server against the one-rank one: float outputs (tanh, in
# [-1, 1]) within this; int8 outputs too, but for this share of the
# elements
DP_SERVE_ATOL = 1e-5
DP_SERVE_INT8_SHARE = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _overrides(family: str, small: bool) -> Dict:
    if family == "ssgan":
        return dict(bn=True, **(dict(dim=4, batch_size=2, seq_len=4)
                                if small else {}))
    if not small:
        return {}
    kw = dict(dim=8, batch_size=8)
    if family == "gmgan":
        kw["n_coms"] = 6
    return kw


def build_model(family: str, dataset: str, mode: str, **kw):
    """The model of ``family`` ("gan", "gmgan", "ssgan") from its config's
    defaults for ``dataset`` and ``mode``, with ``kw`` over them."""
    from graphical_gan_tpu_torch.core import config
    if family == "gan":
        from graphical_gan_tpu_torch.models.gan_inference import (
            GanInferenceModel)
        return GanInferenceModel(config.gan_inference_defaults(
            dataset, mode, **kw))
    if family == "gmgan":
        from graphical_gan_tpu_torch.models.gmgan import GMGanModel
        return GMGanModel(config.gmgan_defaults(dataset, mode, **kw))
    from graphical_gan_tpu_torch.models.ssgan import SSGanModel
    return SSGanModel(config.ssgan_defaults(dataset, mode, **kw))


def _raw(model, it: int, device):
    """Iteration ``it``'s global raw batches [1+k, B, ...] from a numpy
    seed (every rank makes the same)."""
    cfg = model.cfg
    rng = np.random.RandomState(100 + it)
    lead = (1 + cfg.critic_iters, cfg.batch_size)
    if hasattr(cfg, "seq_len"):
        x = rng.rand(*lead, cfg.seq_len, cfg.output_dim).astype(np.float32)
        out = {"x": torch.from_numpy(x).to(device)}
        if cfg.conditional:
            y = np.eye(cfg.n_classes, dtype=np.float32)[
                rng.randint(0, cfg.n_classes, lead)]
            out["y"] = torch.from_numpy(y).to(device)
        return out
    shape = lead + (cfg.data.output_dim,)
    if cfg.data.normalization == "unit":
        x = rng.rand(*shape).astype(np.float32)
    else:
        x = rng.randint(0, 256, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _run(step, state, model, device):
    """ITERS iterations of ``step``, each drawing from a generator seeded
    (seed 7, iteration) as the trainer seeds it; (state, costs)."""
    gen = torch.Generator(device=device)
    costs = []
    for it in range(ITERS):
        gen.manual_seed((7 << 32) + it)
        state, met = step(state, _raw(model, it, device), it > 0, gen)
        costs.append({n: float(v) for n, v in met.items()})
    return state, costs


def _leaves(state) -> Dict[str, torch.Tensor]:
    out = {f"params/{n}": p for n, p in state.params.items()}
    for field in ("gen_opt", "disc_opt"):
        for slot, v in (getattr(state, field) or {}).items():
            if isinstance(v, dict):
                out.update({f"{field}/{slot}/{n}": t for n, t in v.items()})
    return out


def _model(family: str, dataset: str, mode: str, small: bool):
    return build_model(family, dataset, mode, **_overrides(family, small))


def _reference(model, device):
    """The one-device step from the model's seed-0 parameters."""
    from graphical_gan_tpu_torch.train.step import make_train_step
    step, init_state = make_train_step(model)
    return _run(step, init_state(model.init(0, device)), model, device)


# a reference Adam m at most this share of the largest |m| it is held
# against is rounding noise: a gradient 0 in exact arithmetic, or within
# rounding of 0, whose sign another summation order may turn
NOISE = 1e-4


def update_bound(lr: float, updates: int, m_max: Optional[float],
                 top: float) -> float:
    """JAX's criterion for a parameter after ``updates`` Adam updates of
    its player (``tests/test_parallel.py:52-61``): 1.25·lr per update, and
    2·lr per update (a whole flip) where the reference's Adam m of the
    leaf is rounding noise: its largest |m|, ``m_max``, at most NOISE of
    its player's largest, ``top`` (the biases of the convs before a BN,
    whose gradient is 0 in exact arithmetic, so Adam moves them by lr with
    the noise's sign)."""
    per = 2.0 if m_max is not None and m_max <= NOISE * top else 1.25
    return per * lr * max(updates, 1)


def _player(model, key: str):
    """(the leaf's name, its player's optimizer field, lr, updates in
    ITERS iterations)."""
    name = key.split("/", 1)[1]
    disc = name.startswith(tuple(model.DISC_PLAYER))
    gen_spec, disc_spec = model.opt_specs()
    lr = (disc_spec if disc else gen_spec).lr
    updates = model.cfg.critic_iters * ITERS if disc else ITERS - 1
    return name, "disc_opt" if disc else "gen_opt", lr, max(updates, 1)


def _bound(model, key: str, ref_leaves) -> float:
    name, field, lr, updates = _player(model, key)
    ms = [v for k, v in ref_leaves.items() if k.startswith(field + "/m/")]
    top = max(float(v.abs().max()) for v in ms) if ms else 0.0
    mine = ref_leaves.get(f"{field}/m/{name}")
    return update_bound(lr, updates, None if mine is None
                        else float(mine.abs().max()), top)


# the share of a leaf's elements whose update may take the other sign
# than the reference's (a gradient within rounding of 0); a wrong gradient
# would turn a large share
FLIP_SHARE = 1e-3
# a flipped element's Adam m may differ from the reference's by this share
# of the leaf's largest reference |m|: the bound ``chip_smoke.py``'s
# train-parity phase (MOMENT_RTOL) holds the card's moments to against the
# CPU's. G's one update in ITERS iterations takes its gradient at D
# parameters that already differ by D's own flips (each within its bound),
# so a G gradient differs by more than rounding, and its small elements
# may flip; a flip moves m by |m| + |m_ref|, so none lies at a gradient
# above this share.
FLIP_M_SHARE = 5e-2


def _misses(model, costs, ref_costs, full, ref_state, init, flips) -> List:
    """The costs within rtol 2e-4 of the reference's, and each parameter
    within :func:`_bound`; past that bound an element may only be a sign
    flip at a small gradient: its update and the reference's point
    opposite ways, within the full 2·lr per update a flip moves, its Adam
    m differs from the reference's by at most FLIP_M_SHARE of the leaf's
    largest reference |m| (so both lie near 0), and the flips are at most
    FLIP_SHARE of the leaf's elements. ``flips`` gets, per leaf that has
    any, their count, the reference's largest |m| among them and the
    largest gap of m, each also as a share of the leaf's largest
    reference |m|."""
    out = []
    for it, (row, ref) in enumerate(zip(costs, ref_costs)):
        for n, want in ref.items():
            if abs(row[n] - want) > 2e-4 * abs(want) + 1e-6:
                out.append(f"iteration {it} {n}: {row[n]} vs {want}")
    ref_leaves = {k: v.float() for k, v in _leaves(ref_state).items()}
    got_leaves = {k: v.float() for k, v in _leaves(full).items()}
    for key, got in got_leaves.items():
        if not key.startswith("params/"):
            continue
        want = ref_leaves[key]
        if tuple(got.shape) != tuple(want.shape):
            out.append(f"{key}: shape {tuple(got.shape)}")
            continue
        b = _bound(model, key, ref_leaves)
        diff = (got - want).abs()
        over = diff > b
        if not bool(over.any()):
            continue
        name, field, lr, updates = _player(model, key)
        start = init[name].float()
        m_ref = ref_leaves.get(f"{field}/m/{name}")
        m_got = got_leaves.get(f"{field}/m/{name}")
        if m_ref is None or m_got is None:
            out.append(f"{key}: {float(diff.max())} > {b}, no Adam m")
            continue
        top = float(m_ref.abs().max())
        gap = (m_got - m_ref).abs()
        flip = over & (torch.sign(got - start) != torch.sign(want - start))
        small = flip & (gap <= FLIP_M_SHARE * top)
        n_flip = int(small.sum())
        if n_flip:
            worst, worst_gap = float(m_ref.abs()[small].max()), \
                float(gap[small].max())
            flips[key] = {"n": n_flip, "max_ref_m": worst,
                          "max_ref_m_share": worst / top,
                          "max_m_gap_share": worst_gap / top}
        if bool((over & ~small).any()) \
                or float(diff.max()) > max(b, 2.0 * lr * updates) \
                or n_flip > FLIP_SHARE * diff.numel():
            big = over & ~small
            out.append(
                f"{key}: {float(diff.max())} > {b} at {int(over.sum())} "
                f"elements, {int(flip.sum())} sign flips, {n_flip} at small "
                "gradients; largest m gap of the others "
                f"{float(gap[big].max()) / top if bool(big.any()) else 0.0}"
                " of the leaf's largest m")
    return out


def _gloo_takes(device) -> Dict[str, bool]:
    """Which collectives beyond all_reduce and broadcast the group takes on
    this rank's tensors."""
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.ones(4, device=device)
    probes = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(n)]),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty_like(x) for _ in range(n)],
            [x.clone() for _ in range(n)]),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = True
        except Exception:  # noqa: BLE001 - any refusal is the answer
            out[name] = False
    return out


def rank_main(rank: int, world: int, job: Dict) -> Dict:
    """One rank of a run (``job['run']``: "world1" or "ranks")."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.core.device import set_numerics
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.parallel.collectives import gather_stack
    from graphical_gan_tpu_torch.train.trainer import parallel_factory
    set_numerics()
    device = torch.device(job["device"])
    small = job["small"]
    backend = "nccl" if job["run"] == "world1" and device.type == "cuda" \
        else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=job["init"], rank=rank,
                            world_size=world)
    if job["run"] in ("pp", "pp4"):
        try:
            return _pp_main(rank, world, job, device)
        finally:
            dist.destroy_process_group()
    if job["run"] == "serve":
        try:
            return _serve_main(rank, world, job, device)
        finally:
            dist.destroy_process_group()
    result = {"run": job["run"], "backend": backend, "world": world,
              "cases": []}
    try:
        if job["run"] == "ranks":
            result["gloo_takes"] = _gloo_takes(device)
        cases = WORLD1_CASES if job["run"] == "world1" else RANK_CASES
        refs = {}
        if rank == 0:  # the one-device references, before any counting
            for strategy, family, dataset, mode, _ in cases:
                model = _model(family, dataset, mode, small)
                refs[strategy] = _reference(model, device) + (
                    {f"params/{n}": p for n, p in
                     model.init(0, device).items()},)
        kernels.reset_launches()
        runs = []
        for strategy, family, dataset, mode, axes in cases:
            model = _model(family, dataset, mode, small)
            shape = [1] * len(axes)
            shape[-1] = world  # the strategy's own axis takes the ranks
            mesh = make_mesh(shape=shape, axis_names=axes,
                             device=device.type,
                             devices=[device] * world, backend=backend)
            step, init_state, place, gather = parallel_factory(
                model, mesh, strategy)
            state = place(init_state(model.init(0, device)))
            t0 = time.perf_counter()
            state, costs = _run(step, state, model, device)
            full = gather(state)
            runs.append((strategy, model, mesh, step, state, costs, full,
                         time.perf_counter() - t0))
        launches = {**kernels.launches(), **kernels.split_launches()}
        for strategy, model, mesh, step, state, costs, full, secs in runs:
            rec = {"strategy": strategy, "mesh": mesh.shape,
                   "dataset": model.cfg.dataset, "mode": model.cfg.mode,
                   "batch_size": model.cfg.batch_size,
                   "sharded": sorted(step.layout), "seconds": secs}
            # replicas: every rank's full state, and each replicated leaf
            same = True
            for key, t in _leaves(full).items():
                rows = gather_stack(t.contiguous(), mesh.world)
                same &= all(torch.equal(rows[0], r) for r in rows[1:])
            for key, t in _leaves(state).items():
                if key.split("/")[-1] in step.layout:
                    continue
                rows = gather_stack(t.contiguous(), mesh.world)
                same &= all(torch.equal(rows[0], r) for r in rows[1:])
            rec["replicas_bit_identical"] = bool(same)
            if rank == 0:
                ref_state, ref_costs, init = refs[strategy]
                if job["run"] == "world1":
                    rec["bit_identical"] = costs == ref_costs and all(
                        torch.equal(a, b) for a, b in zip(
                            _leaves(full).values(),
                            _leaves(ref_state).values()))
                else:
                    rec["sign_flips"] = {}
                    rec["misses"] = _misses(
                        model, costs, ref_costs, full, ref_state,
                        {k.split("/", 1)[1]: v for k, v in init.items()},
                        rec["sign_flips"])
                rec["costs"] = costs
            if strategy == "tp":
                rec["sharded_resume_bit_identical"] = _sharded_resume(
                    model, mesh, device, job["tmp"])
            if strategy == "dp" and job["run"] == "ranks":
                rec["chunk_bit_identical"] = _chunk_replay(model, mesh,
                                                           job["tmp"])
            result["cases"].append(rec)
        result["launches"] = launches
        return result
    finally:
        dist.destroy_process_group()


def _chunk_replay(model, mesh, tmp: str) -> bool:
    """dp Trainers on the ranks over CHUNK_ITERS iterations of resident
    data (seeded random rows) at ``chunk_size`` 2 and 1: the full states
    (parameters, Adam's m and v, step) bit for bit."""
    from graphical_gan_tpu_torch.train.trainer import Trainer
    cfg = model.cfg
    rng = np.random.RandomState(3)
    shape = (8 * cfg.batch_size, cfg.data.output_dim)
    data = rng.rand(*shape).astype(np.float32) \
        if cfg.data.normalization == "unit" \
        else rng.randint(0, 256, shape).astype(np.uint8)
    states = []
    for chunk in (2, 1):
        tr = Trainer(model, data, os.path.join(tmp, f"chunk_{chunk}"),
                     seed=0, mesh=mesh, parallel="dp", checkpoint_every=0,
                     chunk_size=chunk, render_curves=False)
        tr.train(CHUNK_ITERS)
        full = tr._full_state()
        states.append((full.step, _leaves(full)))
    (s0, a), (s1, b) = states
    return s0 == s1 == CHUNK_ITERS and a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)


def _sharded_resume(model, mesh, device, tmp: str) -> bool:
    """tp for 1 iteration, its state saved through the sharded backend
    (each rank its slices), then iteration 1 from the live state and from
    the restored and placed one: the same bits?"""
    from graphical_gan_tpu_torch.train import checkpoint_orbax
    from graphical_gan_tpu_torch.train.trainer import parallel_factory
    step, init_state, place, gather = parallel_factory(model, mesh, "tp")
    gen = torch.Generator(device=device)

    def iterate(state, it):
        gen.manual_seed((7 << 32) + it)
        return step(state, _raw(model, it, device), it > 0, gen)[0]

    state = iterate(place(init_state(model.init(0, device))), 0)
    path = os.path.join(tmp, f"tp_{model.cfg.dataset}.orbax")
    checkpoint_orbax.save(path, state, {"iteration": 0},
                          step.shard_spec(state))
    live = _leaves(gather(iterate(state, 1)))
    full, extra = checkpoint_orbax.restore(
        path, init_state(model.init(0, device)))
    resumed = _leaves(gather(iterate(place(full), 1)))
    return extra == {"iteration": 0} and all(
        torch.equal(live[k], resumed[k]) for k in live)


def _pp_misses_of(model, costs, ref_costs, full, ref, init):
    """:func:`_misses` of a pipeline run's full state against the staged
    reference's, both unpacked into the standard layout."""
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    from graphical_gan_tpu_torch.train.step import make_train_step
    std_init = make_train_step(model)[1]
    return _misses(model, costs, ref_costs,
                   pp.train_state_from_pp_state(model, full, std_init),
                   pp.train_state_from_pp_state(model, ref, std_init),
                   init, {})


def _migration(model, device) -> Dict[str, bool]:
    """The one-device step's state (2 iterations: both players' moments
    and counts) packed and unpacked again at 2 stages, and a packed state
    unpacked and packed again: bit for bit?"""
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    from graphical_gan_tpu_torch.train.step import make_train_step
    std_init = make_train_step(model)[1]
    ts, _ = _reference(model, device)
    packed = pp.pp_state_from_train_state(model, ts, 2)
    back = pp.train_state_from_pp_state(model, packed, std_init)
    a, b = _leaves(ts), _leaves(back)
    to_pp = all(torch.equal(a[k], b[k]) for k in a) \
        and ts.step == back.step \
        and all(int(getattr(ts, f)["t"]) == int(getattr(back, f)["t"])
                for f in ("gen_opt", "disc_opt"))
    again = pp.pp_state_from_train_state(model, back, 2)
    to_std = all(torch.equal(packed[k], again[k])
                 for k in ("packed", "m", "v", "t"))
    return {"standard_pp_standard": bool(to_pp),
            "pp_standard_pp": bool(to_std)}


def _pp_main(rank: int, world: int, job: Dict, device) -> Dict:
    """One rank of a pipeline run: the cases of ``PP_CASES[world]``."""
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    small = job["small"]
    cases = [_model(*c, small) for c in PP_CASES[world]]
    refs = []
    result = {"run": job["run"], "backend": "gloo", "world": world,
              "cases": []}
    if rank == 0:  # the staged references, before any counting
        for model in cases:
            step, init = pp.make_staged_reference_step(
                model, microbatches=microbatches(model.cfg.batch_size),
                n_stages=world)
            state, costs = _run(step, init(model.init(0, device)), model,
                                device)
            refs.append((state, costs))
        if world == 2:
            result["migration"] = {
                m.cfg.dataset: _migration(m, device) for m in cases}
    kernels.reset_launches()
    runs = []
    for model in cases:
        mesh = make_mesh(shape=(world,), axis_names=("stage",),
                         device=device.type, devices=[device] * world,
                         backend="gloo")
        m = microbatches(model.cfg.batch_size)
        step, init, place, read = pp.make_pp_train_step(
            model, mesh, microbatches=m)
        state = place(init(model.init(0, device)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, costs = _run(step, state, model, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        runs.append((model, step, step.gather_state(state), costs, secs, m,
                     state))
    result["launches"] = {**kernels.launches(), **kernels.split_launches()}
    for i, (model, step, full, costs, secs, m, state) in enumerate(runs):
        clock = step.clock
        rec = {"dataset": model.cfg.dataset, "mode": model.cfg.mode,
               "batch_size": model.cfg.batch_size, "dim": model.cfg.dim,
               "critic_iters": model.cfg.critic_iters,
               "microbatches": m, "stages": world,
               "seconds": secs, "wait_seconds": clock.wait,
               "bubble_share": clock.wait / max(clock.total, 1e-9),
               "gpipe_bubble": (world - 1) / (m + world - 1),
               "row": step.stage}
        # 2 iterations more, warm: the seconds and the bubble of a
        # pipeline whose kernels and plans are all made
        clock.wait = clock.total = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _run(step, state, model, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec.update(warm_seconds=time.perf_counter() - t0,
                   warm_wait_seconds=clock.wait,
                   warm_bubble_share=clock.wait / max(clock.total, 1e-9))
        if rank == 0:
            ref_state, ref_costs = refs[i]
            rec["misses"] = _pp_misses_of(
                model, costs, ref_costs, full, ref_state,
                {n: v for n, v in model.init(0, device).items()})
            rec["costs"] = costs
            rec["t"] = full["t"].tolist()
        result["cases"].append(rec)
    return result


def write_run_dir(path: str, small: bool) -> str:
    """A cifar10 wali-gp run directory (the published width, or
    ``small``'s) of the seed-0 parameters, for the ``serve`` run."""
    from graphical_gan_tpu_torch.core.config import asdict
    from graphical_gan_tpu_torch.train import checkpoint
    model = _model("gan", "cifar10", "wali-gp", small)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(asdict(model.cfg), f)
    checkpoint.save_params(os.path.join(path, "ckpt_0.npz"),
                           model.init(0, "cpu"), {"iteration": 0})
    return path


def _serve_main(rank: int, world: int, job: Dict, device) -> Dict:
    """One rank of the dp server run: per quantization, rank 0 times the
    one-rank server and the dp one on one bucket of seeded latents and
    compares them; the other ranks serve."""
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    mesh = make_mesh(shape=(world,), axis_names=("data",),
                     device=device.type, devices=[device] * world,
                     backend="gloo")
    bucket = 8 if job["small"] else 64
    result = {"run": "serve", "backend": "gloo", "world": world,
              "bucket": bucket, "cases": []}

    def timed(call, z, n=5):
        call(3, z)  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            out = call(3, z)
        return out, (time.perf_counter() - t0) / n * 1e3

    for q in (None, "int8"):
        call, _, shapes, ident = sampler_from_run_dir(
            job["run_dir"], device=device, quantize=q, mesh=mesh)
        if rank:
            result["cases"].append({"quantize": q, "served": call.serve()})
            continue
        z = np.random.RandomState(5).randn(
            bucket, shapes[0][1]).astype(np.float32)
        one, _, _, _ = sampler_from_run_dir(job["run_dir"], device=device,
                                            quantize=q)
        want, one_ms = timed(one, z)
        call(3, z)  # warm
        kernels.reset_launches()
        got = call(3, z)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = {**kernels.launches(), **kernels.split_launches()}
        got, dp_ms = timed(call, z)
        call.stop()
        diff = np.abs(got - want)
        result["cases"].append({
            "quantize": q, "dp_devices": ident.get("dp_devices"),
            "max_abs_err": float(diff.max()),
            "over_atol_share": float((diff > DP_SERVE_ATOL).mean()),
            "one_rank_ms": one_ms, "dp_ms": dp_ms, "launches": launches,
            "shape": list(got.shape)})
    return result


def _spawn(run: str, world: int, device: str, small: bool,
           timeout: float) -> List[Dict]:
    """The ranks of ``run`` in processes of their own; their results."""
    with tempfile.TemporaryDirectory() as tmp:
        job = {"run": run, "device": device, "small": small, "tmp": tmp,
               "init": f"tcp://localhost:{_free_port()}"}
        if run == "serve":
            job["run_dir"] = write_run_dir(os.path.join(tmp, "run"), small)
        procs = []
        for rank in range(world):
            out = os.path.join(tmp, f"rank{rank}.json")
            code = ("import json, sys; from graphical_gan_tpu_torch.tools "
                    "import parallel_check as p; r = p.rank_main("
                    f"{rank}, {world}, {job!r}); json.dump(r, open({out!r}, "
                    "'w'))")
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT, os.environ.get("PYTHONPATH", "")]))
            procs.append((subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out))
        deadline = time.time() + timeout
        logs = []
        try:
            for p, _ in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0])
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [f"rank {r} exited {p.returncode}:\n"
               + log.decode(errors="replace")[-3000:]
               for r, ((p, _), log) in enumerate(zip(procs, logs))
               if p.returncode]
        if bad:
            raise RuntimeError("\n".join(bad))
        return [json.load(open(out)) for _, out in procs]


K1 = "fused_conv2d_bias_act"
K2 = ("bn_stats", "bn_apply", "bn_bwd")
# the split kernels a data-parallel training step launches; a BN forward
# is one bn_stats_local and one bn_apply_split around one all_reduce, a
# BN backward one bn_bwd_local and one bn_bwd_apply_split
SPLIT = ("bn_stats_local", "bn_apply_split", "bn_bwd_local",
         "bn_bwd_apply_split")
# (local, apply) pairs that launch equally often in the ranks run
SPLIT_PAIRS = (("bn_stats_local", "bn_apply_split"),
               ("bn_bwd_local", "bn_bwd_apply_split"))
ONE_LAUNCH_FWD = ("bn_stats", "bn_apply", "bn_apply_q8")
# the ranks of a pipeline run that hold convolutions (K1) and the BNs of
# E and G (K2a, K2b, K2c+K2d at one launch): by stage count
PP_K1_RANKS = {2: (0, 1), 4: (0, 1, 2)}
PP_K2_RANKS = {2: (0,), 4: (0, 1)}


def misses_of(doc: Dict, device: str = "cuda") -> List[str]:
    """What the runs' results miss of the checks (on the CPU the kernels
    run their plain versions: no launches are counted)."""
    out = []
    card = device != "cpu"
    world1, ranks = doc.get("world1"), doc.get("ranks")
    for rec in (world1 or {}).get("cases", []):
        if not rec.get("bit_identical"):
            out.append(f"world1 {rec['strategy']}: not bit-identical to the "
                       "one-device step")
    for name, run in (("world1", world1), ("ranks", ranks)):
        for rec in (run or {}).get("cases", []):
            if rec["strategy"] == "tp" \
                    and not rec.get("sharded_resume_bit_identical"):
                out.append(f"{name} tp: the sharded checkpoint's resume "
                           "differs from the uninterrupted run")
    for rec in (ranks or {}).get("cases", []):
        if rec.get("misses"):
            out.append(f"ranks {rec['strategy']}: {rec['misses'][:5]}")
        if rec["strategy"] == "dp" and not rec.get("chunk_bit_identical"):
            out.append("ranks dp: the Trainer at chunk_size 2 differs from "
                       "chunk_size 1")
        if not rec["replicas_bit_identical"]:
            out.append(f"ranks {rec['strategy']}: replicas differ")
    if ranks is not None and card:
        got = ranks["launches"]
        for name in SPLIT:
            if not got.get(name):
                out.append(f"ranks: {name} never launched")
        for local, apply in SPLIT_PAIRS:
            if got.get(local) != got.get(apply):
                out.append(f"ranks: {got.get(local)} {local} launches for "
                           f"{got.get(apply)} {apply}")
    for run in ("pp", "pp4"):
        res = doc.get(run)
        if res is None:
            continue
        world = len(res)
        for rec in res[0]["cases"]:
            if rec["misses"]:
                out.append(f"{run} {rec['dataset']} {rec['mode']}: "
                           f"{rec['misses'][:5]}")
        for data, checks in res[0].get("migration", {}).items():
            for what, ok in checks.items():
                if not ok:
                    out.append(f"{run} migration {data} {what}: not bit "
                               "for bit")
        if not card:
            continue
        for rank, r in enumerate(res):
            got = r["launches"]
            want = ([K1] if rank in PP_K1_RANKS[world] else []) + \
                (list(K2) if rank in PP_K2_RANKS[world] else [])
            missing = [k for k in want if not got.get(k)]
            if missing:
                out.append(f"{run} rank {rank}: {missing} never launched")
            split = [k for k in SPLIT if got.get(k)]
            if split:
                out.append(f"{run} rank {rank}: split kernels {split} "
                           "launched (microbatch statistics are one "
                           "rank's)")
    serve = doc.get("serve")
    if serve is not None:
        for rec in serve[0]["cases"]:
            q = rec["quantize"]
            if q is None and rec["max_abs_err"] > DP_SERVE_ATOL:
                out.append(f"serve float: {rec['max_abs_err']} over "
                           f"{DP_SERVE_ATOL}")
            if q == "int8" and rec["over_atol_share"] > DP_SERVE_INT8_SHARE:
                out.append(f"serve int8: {rec['over_atol_share']} of the "
                           f"elements over {DP_SERVE_ATOL}")
            if card:
                got = rec["launches"]
                want = ["bn_stats_local"] + (
                    ["bn_apply_split_q8"] if q == "int8"
                    else ["bn_apply_split"])
                missing = [k for k in want if not got.get(k)]
                one = {k: got[k] for k in ONE_LAUNCH_FWD if got.get(k)}
                applies = (got.get("bn_apply_split", 0)
                           + got.get("bn_apply_split_q8", 0))
                if missing or one or got.get("bn_stats_local") != applies:
                    out.append(f"serve {q}: {missing} never launched, "
                               f"one-launch {one}, "
                               f"{got.get('bn_stats_local')} bn_stats_local "
                               f"launches for {applies} applies")
        served = [c["served"] for c in serve[1]["cases"]]
        # the counted dispatch and its warm-up, 5 timed and theirs
        if served != [8, 8]:
            out.append(f"serve: rank 1 served {served} dispatches")
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true",
                   help="narrow widths and small batches (the CPU)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--runs", default=",".join(RUNS),
                   help=f"the runs to make, of {','.join(RUNS)}")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    runs = [r for r in args.runs.split(",") if r]
    unknown = set(runs) - set(RUNS)
    if unknown:
        p.error(f"unknown runs {sorted(unknown)}")
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from graphical_gan_tpu_torch.ops.kernels import build
        build.lib()  # built here once; the ranks load it
        device = "cuda:0"
    else:
        device = "cpu"
    worlds = {"world1": 1, "ranks": args.ranks, "pp": 2, "pp4": 4,
              "serve": 2}
    doc = {}
    for run in RUNS:
        if run not in runs:
            continue
        t0 = time.perf_counter()
        res = _spawn(run, worlds[run], device, args.small, args.timeout)
        print(json.dumps(dict(res[0], run_seconds=time.perf_counter() - t0)),
              flush=True)
        doc[run] = res[0] if run in ("world1", "ranks") else res
    doc["misses"] = misses_of(doc, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
    print(json.dumps({"parallel_check": "done", "misses": doc["misses"]}),
          flush=True)
    if doc["misses"]:
        raise SystemExit(1)
    return doc


if __name__ == "__main__":
    main()
