"""Gloo ranks on the CPU for the port's parallel tests
(``tests/test_torch_parallel_*.py``, ``test_torch_bn_sync.py``).

:func:`start` starts ``world`` Python processes (one per rank), joins
them in one gloo process group through a file store and runs a function
of this module in each; ``join`` returns each rank's result. This module imports
no JAX: a rank imports only PyTorch and the port.

:func:`strategy_worker` runs a strategy's step (``graphical_gan_tpu_torch.
parallel``) on one rank for a few iterations from the parameters, global
raw batches and global draws the test hands it, and returns the rank's
own state, the full state gathered from the slices and the costs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class _Job:
    """Ranks started by :func:`start`; :meth:`join` waits for them."""

    def __init__(self, tmp, procs, timeout):
        self.tmp, self.procs = tmp, procs
        self.deadline = time.time() + timeout

    def join(self) -> List:
        try:
            logs = []
            for p, _ in self.procs:
                try:
                    logs.append(p.communicate(
                        timeout=max(1.0, self.deadline - time.time()))[0])
                except subprocess.TimeoutExpired:
                    for q, _ in self.procs:
                        q.kill()
                    raise
            for rank, ((p, _), log) in enumerate(zip(self.procs, logs)):
                if p.returncode:
                    raise RuntimeError(
                        f"rank {rank} exited {p.returncode}:\n"
                        + log.decode(errors="replace")[-4000:])
            return [torch.load(out, weights_only=False)
                    for _, out in self.procs]
        finally:
            self.tmp.cleanup()


def start(fn: str, world: int, payload, timeout: float = 120.0) -> _Job:
    """Start ``fn(rank, world, payload)`` of this module on ``world`` gloo
    ranks; ``.join()`` returns the ranks' return values in rank order (a
    rank that fails fails it with its output)."""
    tmp = tempfile.TemporaryDirectory()
    pay = os.path.join(tmp.name, "payload.pt")
    torch.save(payload, pay)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([HERE, ROOT]),
               GGAN_RENDER_CURVES="0")
    procs = []
    for rank in range(world):
        out = os.path.join(tmp.name, f"out{rank}.pt")
        code = (f"import _torch_dist as d; d._child({rank}, {world}, "
                f"{tmp.name!r}, {fn!r}, {pay!r}, {out!r})")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out))
    return _Job(tmp, procs, timeout)


def _child(rank, world, tmp, fn, pay, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world)
    try:
        result = globals()[fn](rank, world, torch.load(pay,
                                                       weights_only=False))
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


# -- workers ------------------------------------------------------------------

def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def state_numpy(state) -> Dict[str, np.ndarray]:
    """params/<name>, <gen_opt|disc_opt>/<m|v>/<name> as numpy."""
    out = {f"params/{n}": p.detach().cpu().float().numpy()
           for n, p in state.params.items()}
    for field in ("gen_opt", "disc_opt"):
        for slot, v in (getattr(state, field) or {}).items():
            if isinstance(v, dict):
                for n, t in v.items():
                    out[f"{field}/{slot}/{n}"] = t.detach().cpu().float() \
                        .numpy()
    return out


def strategy_worker(rank: int, world: int, cases: List[Dict]):
    """:func:`strategy_case` of each case, in order, on this rank."""
    return [strategy_case(c) for c in cases]


def strategy_case(p: Dict):
    """One rank of ``p['strategy']`` over a gloo mesh of ``p['shape']`` x
    ``p['axes']``: the step's iterations from ``p['params']`` with the
    global ``p['raws'][it]`` and ``p['noises'][it]``."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.parallel import make_mesh
    rank = dist.get_rank()
    from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
    from graphical_gan_tpu_torch.tools.parallel_check import build_model
    from graphical_gan_tpu_torch.train.trainer import parallel_factory
    model = build_model(p["family"], p["dataset"], p["mode"], **p["kw"])
    mesh = make_mesh(shape=p["shape"], axis_names=p["axes"], device="cpu")
    step, init_state, place, gather_state = parallel_factory(
        model, mesh, p["strategy"])
    state = place(init_state(params_from_jax(p["params"], "cpu")))
    costs = []
    for it, (raw, noise) in enumerate(zip(p["raws"], p["noises"])):
        state, met = step(state, _as_torch(raw), it > 0,
                          noise=_as_torch(noise))
        costs.append({n: float(v) for n, v in met.items()})
    full = state_numpy(gather_state(state))
    return {"rank": rank, "coords": mesh.coords, "costs": costs,
            "local": state_numpy(state), "full": full,
            "sharded": sorted(step.layout)}


def pipeline_worker(rank: int, world: int, cases: List[Dict]):
    """Per case, this rank's stage of ``make_pp_train_step`` over a
    ``stage`` axis of the world: ``p['iters']`` iterations from
    ``p['params']`` with the global ``p['raws'][it]`` and
    ``p['noises'][it]``; the costs, the full state gathered from the
    rows, and the shape of the row this rank held."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.parallel import pipeline as pp
    from graphical_gan_tpu_torch.tools.parallel_check import build_model
    from graphical_gan_tpu_torch.train.checkpoint import params_from_jax
    out = []
    for p in cases:
        model = build_model(p["family"], p["dataset"], p["mode"], **p["kw"])
        mesh = make_mesh(shape=(p["n_stages"],), axis_names=("stage",),
                         device="cpu")
        step, init_state, place, read = pp.make_pp_train_step(
            model, mesh, microbatches=p["microbatches"])
        state = place(init_state(params_from_jax(p["params"], "cpu")))
        costs = []
        for it, (raw, noise) in enumerate(zip(p["raws"], p["noises"])):
            state, met = step(state, _as_torch(raw), it > 0,
                              noise=_as_torch(noise))
            costs.append({n: float(v) for n, v in met.items()})
        full = step.gather_state(state)
        params = read(state)
        out.append({"rank": dist.get_rank(), "costs": costs,
                    "row": tuple(state["packed"].shape),
                    "full": {f: np.asarray(full[f]) for f in
                             ("packed", "m", "v", "t")},
                    "n_params": sum(v.numel() for v in params.values())})
    return out


def bn_sync_worker(rank: int, world: int, cases: List[Dict]):
    """Per case: this rank's rows of ``x`` through ``fused_batchnorm_act``
    with the world as its BN group (K2a and K2c+K2d in their split modes,
    the plain versions here), and the first- and second-order gradients of
    ``sum(y * gy)`` and ``sum(dx * v)`` (the penalty's pattern: the BN's
    input gradient differentiated again)."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.ops.kernels.fused_norm import (
        fused_batchnorm_act)
    from graphical_gan_tpu_torch.parallel.collectives import Group
    group = Group(dist.group.WORLD, world, rank)
    out = []
    for c in cases:
        n = c["x"].shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        x = torch.from_numpy(c["x"][rows]).requires_grad_(True)
        scale = torch.from_numpy(c["scale"]).requires_grad_(True)
        offset = torch.from_numpy(c["offset"]).requires_grad_(True)
        y = fused_batchnorm_act(x, scale, offset, c["act"], group=group)
        gy = torch.from_numpy(c["gy"][rows])
        dx, ds, do = torch.autograd.grad((y * gy).sum(), (x, scale, offset),
                                         create_graph=True)
        v = torch.from_numpy(c["v"][rows])
        ddx, dds = torch.autograd.grad((dx * v).sum(), (x, scale))
        out.append({k: t.detach().numpy() for k, t in dict(
            y=y, dx=dx, dscale=ds, doffset=do, ddx=ddx, ddscale=dds).items()})
    return out


def bn_split_fwd_worker(rank: int, world: int, p: Dict):
    """The split BN forward's exchange on this rank: its rows of
    ``p['x']`` [world * n, C] in the slot form (``bn_stats_local`` with
    its slot of the world's buffer) through ``all_reduce_stack``, and the
    [3, C] triple through ``gather_stack``, as raw bits (int64 views, so a
    -0 and a +0 differ); then :func:`bn_sync_worker` over ``p['cases']``."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
    from graphical_gan_tpu_torch.parallel.collectives import (
        Group, all_reduce_stack, gather_stack)
    group = Group(dist.group.WORLD, world, rank)
    n = p["x"].shape[0] // world
    x = torch.from_numpy(p["x"][rank * n:(rank + 1) * n])
    slot = all_reduce_stack(fn.bn_stats_local(x, rank, world), group)
    stack = gather_stack(fn.bn_stats_local_plain(x), group)
    return {"slot": slot.view(torch.int64).numpy(),
            "stack": stack.view(torch.int64).numpy(),
            "bn": bn_sync_worker(rank, world, p["cases"])}


def bn_split_bwd_worker(rank: int, world: int, p: Dict):
    """The split BN backward's exchange on this rank, from its rows of the
    [world * n, C] ``g`` and ``x`` of ``p`` at the whole batch's
    statistics: the slot form (``bn_bwd_local`` in its slot of the world's
    buffer) through ``all_reduce_stack`` and the [2, C] sums through
    ``gather_stack``, as raw bits (int32 views, so a -0 and a +0 differ);
    dx of ``bn_bwd_apply_split`` on the gathered slots and of
    ``sum_in_rank_order`` then ``bn_bwd_apply_plain`` (the chain it
    replaced), as raw bits; then :func:`bn_sync_worker` over
    ``p['cases']``; then, with ``gather_stack`` and ``sum_in_rank_order``
    patched to raise, one first-order BN backward over the world, and the
    ``all_reduce_stack`` calls it made."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
    from graphical_gan_tpu_torch.parallel import collectives as col
    group = col.Group(dist.group.WORLD, world, rank)
    n = p["x"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    x_all, g_all = torch.from_numpy(p["x"]), torch.from_numpy(p["g"])
    scale, offset = torch.from_numpy(p["scale"]), torch.from_numpy(
        p["offset"])
    mean, _, inv = fn.bn_stats_plain(x_all)
    x, g = x_all[rows], g_all[rows]
    args = (g, x, mean, inv, scale, offset)
    slot = col.all_reduce_stack(fn.bn_bwd_local(*args, rank, world,
                                                p["act"]), group)
    red = fn.bn_bwd_reduce_plain(*args, p["act"])
    stack = col.gather_stack(red, group)
    dx = fn.bn_bwd_apply_split(*args, slot, x_all.shape[0], p["act"])
    chain = fn.bn_bwd_apply_plain(*args, col.sum_in_rank_order(red, group),
                                  p["act"], x_all.shape[0])
    out = {"slot": slot.view(torch.int32).numpy(),
           "stack": stack.view(torch.int32).numpy(),
           "dx": dx.view(torch.int32).numpy(),
           "chain": chain.view(torch.int32).numpy(),
           "bn": bn_sync_worker(rank, world, p["cases"])}

    def refuse(*a, **k):
        raise AssertionError("the split backward gathered or summed "
                             "outside its exchange buffer")

    calls = []
    reduce = col.all_reduce_stack

    def counted(buf, grp):
        calls.append(tuple(buf.shape))
        return reduce(buf, grp)

    col.gather_stack, col.sum_in_rank_order = refuse, refuse
    col.all_reduce_stack = counted
    xg = x.clone().requires_grad_(True)
    y = fn.fused_batchnorm_act(xg, scale, offset, p["act"], group=group)
    forward = len(calls)
    y.backward(g)
    out["calls"] = {"forward": calls[:forward], "backward": calls[forward:]}
    return out


def cli_worker(rank: int, world: int, p: Dict):
    """One rank of a training CLI, ``p['module']``'s ``main(p['argv'])``,
    in the ranks' process group (as torchrun would start it), with the
    families' test data made small: MNIST pools of 24 + 12 digits for
    moving-MNIST, the TSNE of GMGAN's last iteration reported skipped.
    Returns the rank's last costs and the run directory's files."""
    import importlib
    from graphical_gan_tpu_torch.data import moving_mnist
    from graphical_gan_tpu_torch.runs import gmgan
    rng = np.random.RandomState(0)
    pools = ((rng.rand(24, 28, 28).astype(np.float32),
              rng.randint(0, 10, 24)),
             (rng.rand(12, 28, 28).astype(np.float32),
              rng.randint(0, 10, 12)))
    moving_mnist._mnist_pool = lambda cla, data_dir=None: pools
    gmgan._missing_module = lambda names: "sklearn.manifold: not here"
    out = importlib.import_module(p["module"]).main(p["argv"])
    run_dir = p["argv"][p["argv"].index("--outdir") + 1]
    files = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                   for d, _, fs in os.walk(run_dir) for f in fs)
    return {"rank": rank, "files": files,
            "ok": out is None or isinstance(out, tuple)}


def _numpy_state(state) -> Dict[str, np.ndarray]:
    if isinstance(state, dict):  # a pipeline state
        return {k: np.asarray(state[k]) for k in ("packed", "m", "v", "t")}
    return state_numpy(state)


def trainer_worker(rank: int, world: int, p: Dict):
    """Per run of ``p['runs']``, in order: a Trainer
    (``_torch_trainer.make_trainer``, resident rows; ``dataset``/``mode``
    over its mnist ali) on a gloo mesh of ``shape`` x ``axes`` with
    ``parallel`` and ``backend``, checkpointing every ``every`` in
    ``outf``, trained to ``iters``: the iteration it started at, its last
    costs and the full state (``_numpy_state``) with its parameters. A run
    ``{"cli": p}`` is :func:`cli_worker`'s ``p`` instead."""
    from _torch_trainer import make_trainer
    from graphical_gan_tpu_torch.parallel import make_mesh
    out = []
    for r in p["runs"]:
        if "cli" in r:  # a training CLI's main on the ranks instead
            out.append(cli_worker(rank, world, r["cli"]))
            continue
        mesh = make_mesh(shape=r["shape"], axis_names=r["axes"],
                         device="cpu")
        tr = make_trainer(r["outf"], resident=True, mesh=mesh,
                          parallel=r["parallel"],
                          checkpoint_backend=r["backend"],
                          checkpoint_every=r["every"], render_curves=False,
                          **r.get("model", {}))
        last = tr.train(iters=r["iters"])
        full = tr._full_state()
        out.append({"rank": rank, "start": tr._start_iter, "last": last,
                    "full": _numpy_state(full),
                    "params": {n: v.numpy() for n, v in
                               tr._read_params(full).items()}})
    return out


def server_dp_worker(rank: int, world: int, p: Dict):
    """A ``--dp-devices`` server's entry over the world (a ``data`` mesh
    of gloo ranks on the CPU), per quantization of ``p['quantize']``:
    rank 0 calls it on each ``(seed, inputs)`` of ``p['requests']`` and
    once through a ``BatchingSampler`` (a 5-row request padded to the
    bucket of 8), whose close stops the others, which serve meanwhile."""
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.serve.server import (
        BatchingSampler, sampler_from_run_dir)
    mesh = make_mesh(world, device="cpu")
    out = {}
    for q in p["quantize"]:
        call, kinds, shapes, ident = sampler_from_run_dir(
            p["run_dir"], device="cpu", quantize=q, mesh=mesh)
        if rank:
            out[str(q)] = {"served": call.serve()}
            continue
        outs = [call(seed, *inputs) for seed, inputs in p["requests"]]
        batcher = BatchingSampler(call, kinds, shapes, buckets=(8,),
                                  dp_devices=world)
        try:
            batched = batcher.submit(n=5, seed=3).wait(60)
        finally:
            batcher.close()  # and the other ranks' loops
        out[str(q)] = {"outs": outs, "batched": batched,
                       "identity": ident}
    return out


def rollback_worker(rank: int, world: int, p: Dict):
    """One rank of a dp Trainer (``_torch_trainer.make_trainer``, resident
    rows) in ``p['outf']`` with async checkpoints whose writes take
    ``p['delay']`` seconds longer, and the divergence guard poisoning
    ``p['nan_at']``: the iteration each restore resumed at, and the full
    state at the end."""
    from _torch_trainer import make_trainer
    from graphical_gan_tpu_torch.parallel import make_mesh
    from graphical_gan_tpu_torch.train import checkpoint
    save = checkpoint._save_flat

    def slow(*args, **kw):
        time.sleep(p["delay"])
        return save(*args, **kw)

    checkpoint._save_flat = slow
    os.environ["GGAN_FAULT_NAN_AT"] = str(p["nan_at"])
    mesh = make_mesh(n_devices=world, device="cpu")
    tr = make_trainer(p["outf"], resident=True, mesh=mesh, parallel="dp",
                      async_checkpoint=True, max_rollbacks=1,
                      checkpoint_every=p["every"], render_curves=False)
    restores = []
    resume = tr.try_resume

    def spy():
        ok = resume()
        restores.append(tr._start_iter if ok else None)
        return ok

    tr.try_resume = spy
    tr.train(iters=p["iters"])
    return {"rank": rank, "restores": restores,
            "full": state_numpy(tr._full_state())}
