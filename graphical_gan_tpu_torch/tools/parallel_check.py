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
   launch counts (set to 0 just before the strategies run) and which
   collectives gloo takes on the ranks' tensors (``all_gather``,
   ``reduce_scatter``, ``all_to_all``, ``barrier``) are reported.

Each run prints one JSON line; ``--out`` also writes them as one JSON
document. Exits nonzero if a check fails. Runs on ``cuda`` unless
``--device cpu``; without a card it raises.
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
    kw = dict(dim=8, batch_size=4)
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
            result["cases"].append(rec)
        result["launches"] = launches
        return result
    finally:
        dist.destroy_process_group()


def _spawn(run: str, world: int, device: str, small: bool,
           timeout: float) -> List[Dict]:
    """The ranks of ``run`` in processes of their own; their results."""
    with tempfile.TemporaryDirectory() as tmp:
        job = {"run": run, "device": device, "small": small,
               "init": f"tcp://localhost:{_free_port()}"}
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


def misses_of(world1: Dict, ranks: Dict, device: str = "cuda"
              ) -> List[str]:
    """What the two runs' rank-0 results miss of the checks (on the CPU
    the split kernels run their plain versions: no launches)."""
    out = []
    for rec in world1["cases"]:
        if not rec.get("bit_identical"):
            out.append(f"world1 {rec['strategy']}: not bit-identical to the "
                       "one-device step")
    for rec in ranks["cases"]:
        if rec.get("misses"):
            out.append(f"ranks {rec['strategy']}: {rec['misses'][:5]}")
        if not rec["replicas_bit_identical"]:
            out.append(f"ranks {rec['strategy']}: replicas differ")
    for name in ("bn_stats_local", "bn_stats_merge", "bn_bwd_reduce",
                 "bn_bwd_apply"):
        if device != "cpu" and not ranks["launches"].get(name):
            out.append(f"ranks: {name} never launched")
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true",
                   help="narrow widths and small batches (the CPU)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from graphical_gan_tpu_torch.ops.kernels import build
        build.lib()  # built here once; the ranks load it
        device = "cuda:0"
    else:
        device = "cpu"
    world1 = _spawn("world1", 1, device, args.small, args.timeout)[0]
    print(json.dumps(world1), flush=True)
    ranks = _spawn("ranks", args.ranks, device, args.small, args.timeout)
    print(json.dumps(ranks[0]), flush=True)
    doc = {"world1": world1, "ranks": ranks[0],
           "misses": misses_of(world1, ranks[0], device)}
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
