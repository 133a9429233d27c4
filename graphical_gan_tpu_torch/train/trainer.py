"""Host-side training loop: a subset of ``graphical_gan_tpu/train/
trainer.py``.

It keeps the reference's instruments and cadences: a settings dump
(``config.json`` and ``\\tKEY: value`` lines in ``logfile.txt``), the
parameter count, ``iter N\\ttrain disc cost\\t...`` lines at iterations < 5
and every 100th, the dev-set sweep every 100 iterations (``dev gen cost``,
or ``dev rec cost`` and ``dev reg cost`` where the mode has a
reconstruction term), and the eval hooks (sample and reconstruction grids,
quality metrics) at their cadences, fired after the window's flush at
``iteration % every == every - 1``, with a last flush at the end so what
they plot at the final boundary reaches the log. And the JAX trainer's
improvements the port needs to train at all: the resident dataset
(uploaded once, each iteration's (1+k) batches gathered on the device, or
made there by a ``batch_sampler``) or the host-fed path ((1+k)
consecutive loader batches stacked on the host and copied ahead by
``data/prefetch.py``), ``ckpt_<iter>.npz`` of the
whole ``TrainState`` every ``checkpoint_every`` iterations and at the end
(the last ``checkpoints_to_keep`` kept), and resume from the latest
checkpoint of the run directory.

Each iteration's random draws come from one ``torch.Generator`` on the
device, seeded from (seed, iteration) on salt 0 (``(seed << 32) +
iteration``), so a resumed run draws what an uninterrupted one would (on
the resident path; the host-fed stream, as in JAX, restarts at the loader's
first epoch). After a rollback the iterations draw on salt r >= 1, seeded
``2**63 + (seed << 40) + (r << 32) + 2**31 + (r << 24) + iteration``. On the
card (Philox, all 64 bits) bit 63 is set in no salt-0 seed and in no eval
seed; a CPU generator (MT19937) reads only the low 32 bits, where bit 31 is
set in no salt-0 or eval seed either, and the salt bits keep the salted
streams apart on both (for seeds below 2**23, salts below 128 and
iterations below 2**24).
The dev sweep and the hooks draw from generators seeded from (seed, their
salt, iteration), ``(seed << 40) + (salt << 32) + iteration`` with salt >=
1 (``eval_generator``), so a resumed run scores as an uninterrupted one.

The resident path runs JAX's chunked loop (JAX ``train/trainer.py:
184-203, 801-945``). The iterations up to the next host event (the
100-iteration dev and flush cadence, ``checkpoint_every``, each eval hook's
cadence, the early boundaries 1-5 and the run's end) form a window; the
window runs as dispatches of ``chunk_size`` iterations (``None``: the whole
window, at most 100). A dispatch runs its iterations back to back, each
seeded, drawn and stepped as above, and queues each iteration's logged
cost as a device scalar; nothing is fetched inside it. At the window's
end the queued costs come to the host in one copy, the divergence guard
and ``GGAN_FAULT_NAN_AT`` act on the window, each iteration's cost and
``time`` (the window's wall time over its iterations) are plotted, and
then the dev sweep, the flush, the hooks and the checkpoint run, in JAX's
order. The draws are keyed by (seed, salt,
iteration), not by dispatch, so every ``chunk_size`` gives the same
parameters, optimizer state, step, costs and checkpoints, bit for bit;
only ``time`` differs. The host-fed path runs one iteration at a time and
ignores ``chunk_size``, as JAX's does.

On a CUDA device with no mesh, a dispatch replays one CUDA graph per
iteration, JAX's jitted step (``:182``; ``train/graph.py``). The rule is
:meth:`Trainer.eager_reason`, decided before any capture: it names why a
run stays eager (the CPU, a mesh, the host-fed loop), and None lets the
graph run. Under it, the iterations run eagerly until one with ``do_gen``
has (iterations 0 and 1 of a fresh run, the first after a resume), that
one on the graph's capture stream; the next captures the iteration's body
once per Trainer (again after a resume or a rollback, which replace the
state's tensors) and every later one replays it, seeded and given its
Adam step sizes by the host before each replay, its logged cost copied
out after. A replay gives the eager iteration's bits. A
capture error raises: there is no eager fallback, and JAX's step down to
shorter chunks when a scanned program fails to compile (``:813-842``) has
no counterpart, since one iteration's graph has no size cap; an exception
from the step propagates.

``GGAN_PROFILE=<dir>`` traces iterations ``GGAN_PROFILE_START`` (default
10) to ``GGAN_PROFILE_START + GGAN_PROFILE_STEPS - 1`` (default 10 of them)
under ``torch.profiler`` (CPU and, on the card, CUDA activities, with the
ops' input shapes) and writes a Chrome trace,
``ggan.<first>-<last>.<pid>.<ns>.trace.json.gz``, into ``<dir>`` for
``tools/trace_report.py`` (JAX ``train/trainer.py:491-519, 609-620,
865-891``). On the resident path the trace opens at the dispatch that
holds ``GGAN_PROFILE_START`` and closes after the one that reaches
``GGAN_PROFILE_START + GGAN_PROFILE_STEPS``, so ``<first>-<last>`` in its
name are the iterations it holds. Under the step graph the trace opens
with a new graph: its first iteration is the warm-up, its second the
capture, the rest replays (:meth:`_start_profile`). The trace reads the
step and changes none of its values.

Failure handling (JAX ``train/trainer.py:45-66, 229-330, 365-420,
495-600``):

- **Preemption.** ``request_preempt()`` (SIGTERM through
  ``install_preempt_handlers()``) stops the loop after the iteration in
  flight (on the resident path, after the dispatch in flight, which ends
  its window there; on the card the host runs one dispatch ahead of the
  device at most): the pending costs are drained into the log, that
  iteration is checkpointed, ``preempted: checkpoint saved at iteration
  N; resume with --run-dir`` is logged, and ``train()`` returns with
  ``preempted`` set. At the default ``chunk_size`` a dispatch runs up to
  the next host event, up to 100 iterations, so the stop waits up to that
  many iterations; a smaller ``chunk_size`` bounds the wait.
- **Divergence guard.** With ``max_rollbacks > 0`` each drained window of
  training costs is checked for finiteness; a non-finite cost restores the
  latest checkpoint (an anchor ``ckpt_-1`` is written first where none
  exists; the window's first non-finite iteration over the ranks is the
  one reported) and retries on salt ``salt_high + 1``, never a salt
  that already diverged, also across restarts (``rng_salt`` and
  ``rng_salt_high`` are in each checkpoint's extras).
  ``GGAN_FAULT_NAN_AT=<iter>`` poisons that iteration's observed cost
  once (inert without the guard). A preemption whose drained costs are
  not finite rolls back instead of checkpointing.
- **Async checkpoints** (``async_checkpoint=True`` or
  ``GGAN_ASYNC_CKPT=1``): ``save()`` clones the state on the card and a
  worker thread copies it to the host and writes it
  (``checkpoint.AsyncWriter``); the writer is joined before every restore
  and rollback and at the end of ``train()``.
- ``checkpoints_to_keep`` checkpoints are kept (0 or less keeps all).

Parallel training (``mesh=``, ``parallel=``; JAX ``train/trainer.py:
97-175``): one Trainer per rank, each on its rank's device, over a
``parallel/mesh.py: Mesh``, with JAX's strategies ``dp``, ``tp``, ``sp``,
``ep``, ``composed`` and ``pp`` (``parallel/pipeline.py``: a ``stage``
axis of 2 or 4 ranks; its state is the packed ``{packed, m, v, t,
step}``, which ``read_params`` unpacks for the hooks and the parameter
count; no ``lr_scale``). Every rank draws the iteration's global batch
and noise from the one seed and the strategy's step keeps its rows
(``parallel/mesh.py``; pp's stage 0 takes the batch). Rank 0
alone logs, plots, runs the dev sweep and the eval hooks (on the full
parameters, which every rank gathers first) and writes checkpoints (the
full state, gathered on every rank first, also for the async writer, so a
sharded run writes the npz a one-device run writes; a resume reads it
and shards it again); the others wait at a barrier. A preemption request
and the divergence guard's verdict are agreed over the ranks (a max over
the ranks of the flag), so no rank stops alone while the others wait in a
collective; a restore (resume, rollback) waits until rank 0's writer has
joined and takes the checkpoint rank 0 lists, so every rank restores the
same iteration. These agreements and the barriers run over the mesh's
host group (gloo on CPU tensors), so the preemption check syncs no
device; the resident path makes it once per dispatch, the host-fed path
once per iteration.

Checkpoints (JAX ``train/trainer.py:215-226, 394-470``):
``checkpoint_backend="npz"`` (default) writes ``ckpt_<iter>.npz`` of the
full state from rank 0; ``"orbax"`` writes ``ckpt_<iter>.orbax``
directories in which every rank writes its own part, the slices it holds
(``train/checkpoint_orbax.py``; synchronous, also with
``async_checkpoint``). Both formats may lie in one run directory: a
resume takes the latest of either and reads it into the full state,
which ``place`` cuts for the run's layout, so a run resumes under another
strategy or backend. A pipeline checkpoint and a standard one convert
into each other (``parallel/pipeline.py: pp_state_from_train_state``,
``train_state_from_pp_state``): a dp, tp or one-device run resumes under
pp at 2 or 4 stages, a pp run resumes unsharded or at another stage
count.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from dataclasses import asdict, is_dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core import tree
from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.data.prefetch import prefetch_to_device
from graphical_gan_tpu_torch.report.plot import MetricLogger
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.graph import StepGraph
from graphical_gan_tpu_torch.train.step import make_train_step


class DivergenceError(RuntimeError):
    """A non-finite training cost that the guard could not recover from: no
    checkpoint to roll back to, or the rollback budget is spent."""


class _Diverged(Exception):
    """Control flow: a non-finite training cost at ``iteration``."""

    def __init__(self, iteration: int):
        super().__init__(iteration)
        self.iteration = int(iteration)


class _PreemptStop(Exception):
    """Control flow: a preemption request honored after ``iteration``;
    ``metrics`` are its last costs."""

    def __init__(self, iteration: int, metrics: Dict[str, float]):
        super().__init__(iteration)
        self.iteration = int(iteration)
        self.metrics = dict(metrics)


PARALLEL_CHOICES = ("dp", "tp", "sp", "ep", "composed", "pp")


def parallel_factory(model, mesh, parallel: str, lr_scale=None):
    """``(step, init_state, place, gather_state)`` of strategy ``parallel``
    over ``mesh`` (JAX ``train/trainer.py:135-172``); for ``pp``
    ``(step, init_state, place, read_params)``, its ``gather_state``
    being ``step.gather_state``."""
    from graphical_gan_tpu_torch import parallel as par
    if parallel == "dp":
        return par.make_parallel_train_step(model, mesh, lr_scale)
    if parallel == "tp":
        return par.make_tp_train_step(model, mesh, lr_scale=lr_scale)
    if parallel == "sp":
        return par.make_sp_train_step(model, mesh, lr_scale=lr_scale)
    if parallel == "ep":
        return par.make_ep_train_step(model, mesh, lr_scale=lr_scale)
    if parallel == "composed":
        return par.make_composed_train_step(
            model, mesh, data_axis="data" if "data" in mesh.shape else None,
            seq_axis="seq" if "seq" in mesh.shape else None,
            model_axis="model" if "model" in mesh.shape else None,
            lr_scale=lr_scale)
    if parallel == "pp":
        if lr_scale is not None:
            raise NotImplementedError(
                "pipeline parallelism does not support lr_scale")
        return par.make_pp_train_step(model, mesh)
    raise ValueError(f"unknown parallel strategy {parallel!r}")


def make_run_dir(base: str, script: str, tags: Dict) -> str:
    parts = [script] + [f"{k}-{v}" for k, v in tags.items()] \
        + [str(int(time.time()))]
    outf = os.path.join(base, ".".join(parts))
    os.makedirs(outf, exist_ok=True)
    return outf


def shared_run_dir(mesh, base: str, script: str, tags: Dict) -> str:
    """:func:`make_run_dir` on rank 0, its path on every rank of ``mesh``
    (None: this process alone)."""
    if mesh is None or mesh.size == 1:
        return make_run_dir(base, script, tags)
    from graphical_gan_tpu_torch.parallel.collectives import gather_stack
    buf = torch.zeros(4096, dtype=torch.uint8, device=mesh.device)
    if mesh.rank == 0:
        raw = make_run_dir(base, script, tags).encode()
        if len(raw) >= buf.numel():
            raise ValueError(f"run directory path over {buf.numel()} bytes")
        buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    row = gather_stack(buf, mesh.world)[0].cpu().numpy()
    return bytes(row[:int((row != 0).sum())]).decode()


def dump_settings(outf: str, cfg, logfile: str) -> None:
    d = asdict(cfg) if is_dataclass(cfg) else dict(cfg)
    with open(os.path.join(outf, "config.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)
    with open(logfile, "a") as f:
        for k in sorted(d):
            f.write(f"\t{k.upper()}: {d[k]}\n")


# the dev set stays on the device up to this many bytes; a larger one keeps
# its first batches that fit (``graphical_gan_tpu/train/trainer.py:977-1000``)
DEV_RESIDENT_MAX = 512 * 1024 * 1024
# the salt of the dev sweep's generator; the eval hooks take 2, 3, ...
DEV_SALT = 1
# set in the seed of every salted training stream, and in no other seed:
# bit 63 for the card's generator, bit 31 for the CPU's (which reads the low
# 32 bits only)
SALTED_STREAM_BITS = (1 << 63) | (1 << 31)


class Trainer:
    """``resident_data`` [N, ...] (or a dict of aligned arrays) is
    uploaded once and sampled on the device: ``batch_sampler(data,
    generator, n, batch_size)`` makes an iteration's n = 1+k batches from
    it (default: a uniform gather, one index draw for every leaf; SSGAN's
    device path synthesizes videos from a digit pool,
    ``data/ondevice_moving_mnist.py``). With ``resident_data=None`` the
    host-fed path runs over ``train_gen_factory`` (a loader's
    epoch-generator factory; its batches may be arrays or dicts of
    arrays, and an ``(x, y)`` tuple feeds x alone).
    ``eval_hooks`` maps a cadence to ``hook(trainer, iteration)``;
    ``dev_gen_factory`` gives the dev batches the sweep averages over;
    ``lr_scale(t)`` scales Adam's step size at its step count t (the
    linear decay of ``cfg.decay``, ``runs/gan_inference.py``).
    ``chunk_size`` is the resident path's iterations per dispatch
    (``None``: up to the next host event, at most 100; else at least 1).
    ``checkpoints_to_keep``, ``max_rollbacks`` and ``async_checkpoint``
    are the failure handling of the module docstring. ``render_curves``
    (default: ``GGAN_RENDER_CURVES``, on unless "0") writes the
    logger's curve images into ``outf`` at each flush
    (``report/plot.py``). Any model of
    the port trains: it gives ``gen_loss`` / ``disc_loss`` with their aux
    (``gen_cost``, ``rec_cost``), ``opt_specs``, the players' names and
    ``DISC_ONLY_DRAWS`` (``models/gan_inference.py``, ``models/
    gmgan.py``)."""

    def __init__(self, model, resident_data: Optional[np.ndarray], outf: str,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 checkpoint_every: int = 5000,
                 eval_hooks: Optional[Dict[int, Callable]] = None,
                 dev_gen_factory: Optional[Callable] = None,
                 train_gen_factory: Optional[Callable] = None,
                 lr_scale: Optional[Callable[[float], float]] = None,
                 batch_sampler: Optional[Callable] = None,
                 checkpoints_to_keep: int = 3, max_rollbacks: int = 0,
                 async_checkpoint: Optional[bool] = None,
                 render_curves: Optional[bool] = None,
                 mesh=None, parallel: str = "dp",
                 checkpoint_backend: str = "npz",
                 chunk_size: Optional[int] = None):
        if resident_data is None and train_gen_factory is None:
            raise ValueError("the Trainer needs resident_data or, for the "
                             "host-fed path, train_gen_factory")
        if checkpoint_backend not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint_backend "
                             f"{checkpoint_backend!r} (npz|orbax)")
        self.checkpoint_backend = checkpoint_backend
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self.parallel = parallel if mesh is not None else "dp"
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.rank0 = mesh is None or mesh.rank == 0
        set_numerics()
        self.outf = outf
        self.logfile = os.path.join(outf, "logfile.txt")
        if self.rank0:
            os.makedirs(outf, exist_ok=True)
            dump_settings(outf, self.cfg, self.logfile)
        self.seed = int(seed)
        self.checkpoint_every = checkpoint_every
        self.k = self.cfg.critic_iters
        # the name-keyed parameters of a (full) state: pp unpacks its rows
        self._read_params = lambda state: state.params
        if mesh is None:
            self.step_fn, self.init_state = make_train_step(model, lr_scale)
            self._place = self._gather = lambda state: state
        elif self.parallel == "pp":
            self.step_fn, self.init_state, self._place, \
                self._read_params = parallel_factory(model, mesh, "pp",
                                                     lr_scale)
            self._gather = self.step_fn.gather_state
        else:
            self.step_fn, self.init_state, self._place, self._gather = \
                parallel_factory(model, mesh, parallel, lr_scale)
        self._full_params = None
        self.data = None if resident_data is None else to_device(
            resident_data, self.device)
        self.batch_sampler = batch_sampler or (
            lambda data, gen, n, b: sample_batches(data, n, b, gen))
        self.chunk_size = None if chunk_size is None else max(1, chunk_size)
        self.train_gen_factory = train_gen_factory
        self.dev_gen_factory = dev_gen_factory
        self._dev_data = None
        self.eval_hooks = {e: h for e, h in (eval_hooks or {}).items()
                           if e > 0}
        self.generator = torch.Generator(device=self.device)
        # each flush re-renders one curve image per metric into outf, as the
        # reference does (tflib/plot.py:22-41), where matplotlib imports;
        # GGAN_RENDER_CURVES=0 turns it off, the argument wins over it
        if render_curves is None:
            render_curves = os.environ.get("GGAN_RENDER_CURVES", "1") != "0"
        self.render_curves = render_curves
        self.logger = MetricLogger()
        self.state = None
        self._start_iter = 0
        self.checkpoints_to_keep = checkpoints_to_keep
        self.max_rollbacks = max(0, max_rollbacks or 0)
        self._rollbacks = 0
        # the salt of the training stream, and the highest salt this run
        # has used (a rollback takes salt_high + 1)
        self._salt = 0
        self._salt_high = 0
        self._fault_nan_at = int(os.environ.get("GGAN_FAULT_NAN_AT", "-1"))
        self._fault_fired = False
        self._preempt = threading.Event()
        self.preempted = False
        if async_checkpoint is None:
            async_checkpoint = os.environ.get("GGAN_ASYNC_CKPT") == "1"
        self._ckpt_writer = (ckpt_lib.AsyncWriter() if async_checkpoint
                             else None)
        # the resident iteration's CUDA graph (eager_reason), the captures
        # this Trainer made, the iterations its graphs ran, and the eager
        # dispatch asked for on the card
        self._graph: Optional[StepGraph] = None
        self.captures = 0
        self.replays = 0
        self._eager = False

    def _log(self, line: str) -> None:
        if not self.rank0:
            return
        print(line)
        with open(self.logfile, "a") as f:
            f.write(line + "\n")

    def fresh_state(self):
        """A fresh TrainState from ``model.init(seed)``, placed on the mesh
        (each rank's slices) where there is one."""
        return self._place(self.init_state(self.model.init(self.seed,
                                                           self.device)))

    @property
    def params(self):
        """The current parameters (what eval hooks and tools read): under
        a mesh the full ones rank 0 holds while its hooks run."""
        if self._full_params is not None:
            return self._full_params
        return self._read_params(self.state)

    # -- ranks --------------------------------------------------------------

    def _multi(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _barrier(self) -> None:
        """Every rank here before any goes on; over the mesh's host group,
        so it waits for no device work."""
        if self._multi():
            from graphical_gan_tpu_torch.parallel.collectives import (
                sum_in_rank_order)
            sum_in_rank_order(torch.zeros(1), self.mesh.host)

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` of any rank, agreed on every rank (host group: no
        device sync)."""
        if not self._multi():
            return bool(flag)
        from graphical_gan_tpu_torch.parallel.collectives import all_max
        return bool(all_max(torch.tensor([1.0 if flag else 0.0]),
                            self.mesh.host).item() > 0)

    def _latest(self) -> Optional[str]:
        """The latest checkpoint once every write in flight is on disk: the
        one rank 0 (the writer) sees, on every rank."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.join()  # never restore a checkpoint mid-write
        if not self._multi():
            return ckpt_lib.latest(self.outf)
        from graphical_gan_tpu_torch.parallel.collectives import broadcast
        self._barrier()  # rank 0's writer has joined
        ckpts = ckpt_lib.list_checkpoints(self.outf)
        pick = torch.tensor([1, ckpts[-1][0]] if ckpts else [0, 0],
                            dtype=torch.int64)
        has, step = broadcast(pick, self.mesh.host).tolist()
        if not has:
            return None
        path = dict(ckpts).get(step)
        if path is None:
            raise RuntimeError(f"checkpoint {step} of {self.outf} is not "
                               f"visible to rank {self.mesh.rank}")
        return path

    def _full_state(self):
        """The whole TrainState (every rank gathers the slices)."""
        return self._gather(self.state)

    def on_rank0(self, fn, full: bool = False) -> None:
        """Run ``fn()`` on rank 0 alone, outside the step's sharding, with
        the full parameters where ``full`` (gathered on every rank first);
        the other ranks wait at a barrier."""
        if self.mesh is None:
            fn()
            return
        params = self._read_params(self._full_state()) if full else None
        if self.rank0:
            self._full_params = params
            try:
                fn()
            finally:
                self._full_params = None
        self._barrier()

    def eval_generator(self, salt: int, iteration: int) -> torch.Generator:
        """A generator on the device for an evaluation at ``iteration``,
        seeded from (seed, salt, iteration): salt 0 is never used, so no
        evaluation draws a training iteration's stream."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed << 40) + (salt << 32) + iteration)
        return gen

    # -- preemption -----------------------------------------------------------

    def request_preempt(self) -> None:
        """Ask the loop to stop after the iteration in flight, checkpoint it
        and return. Safe from signal handlers and other threads: it only
        sets an event."""
        self._preempt.set()

    def install_preempt_handlers(self, signals=None) -> None:
        """Route termination signals (default: SIGTERM only; Ctrl-C still
        interrupts) into :meth:`request_preempt`. A foreign previous handler
        is chained; one an earlier Trainer installed is replaced, and
        ``self`` is held by weakref, so repeated runs in one process build
        no chain that keeps old trainers alive. Nothing is installed off
        the main thread, where ``signal.signal`` is not allowed."""
        import signal as _signal
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in signals or (_signal.SIGTERM,):
            prev = _signal.getsignal(sig)
            if getattr(prev, "_ggan_preempt", False):
                prev = getattr(prev, "_ggan_chained_prev", None)
            ref = weakref.ref(self)

            def handler(signum, frame, _prev=prev, _ref=ref):
                tr = _ref()
                if tr is not None:
                    tr.request_preempt()
                if callable(_prev) and _prev not in (_signal.SIG_IGN,
                                                     _signal.SIG_DFL):
                    _prev(signum, frame)

            handler._ggan_preempt = True
            handler._ggan_chained_prev = prev
            _signal.signal(sig, handler)

    def _preempt_stop(self, iteration: int, metrics: Dict) -> None:
        self.save(iteration)
        self._log(f"preempted: checkpoint saved at iteration {iteration}; "
                  "resume with --run-dir (or Trainer.try_resume)")
        raise _PreemptStop(iteration,
                           {k: float(v) for k, v in metrics.items()})

    # -- checkpoint -----------------------------------------------------------

    def save(self, iteration: int) -> str:
        # rng_* keep the JAX trainer's resume fields: the port's stream is
        # (seed, salt, iteration), so the position is the iteration count
        extra = {"iteration": iteration, "seed": self.seed,
                 "rng_count": iteration + 1, "rng_salt": self._salt,
                 "rng_salt_high": max(self._salt_high, self._salt)}
        path = os.path.join(self.outf,
                            f"ckpt_{iteration}.{self.checkpoint_backend}")
        if self.checkpoint_backend == "orbax":
            return self._save_sharded(path, extra)
        # a sharded state is gathered on every rank, and rank 0 writes it
        state = self._full_state()
        if self._ckpt_writer is not None:
            if self.rank0:
                leaves, ready = ckpt_lib.snapshot(state)
                self._ckpt_writer.submit(path, leaves, extra, ready,
                                         after=self._gc_checkpoints)
            return path
        if self.rank0:
            ckpt_lib.save_state(path, state, extra)
            self._gc_checkpoints()
        self._barrier()
        return path

    def _save_sharded(self, path: str, extra: Dict) -> str:
        """Every rank writes its part of the state into the ``.orbax``
        directory (the slices it holds, ``step.shard_spec``); synchronous,
        after any npz write in flight."""
        from graphical_gan_tpu_torch.train import checkpoint_orbax
        if self._ckpt_writer is not None:
            self._ckpt_writer.join()
        spec = getattr(self.step_fn, "shard_spec", None)
        checkpoint_orbax.save(path, self.state, extra,
                              spec(self.state) if spec is not None else None)
        self._gc_checkpoints()
        self._barrier()
        return path

    def _gc_checkpoints(self) -> None:
        if not self.rank0 or not self.checkpoints_to_keep \
                or self.checkpoints_to_keep <= 0:
            return
        for _, old in ckpt_lib.list_checkpoints(
                self.outf)[:-self.checkpoints_to_keep]:
            ckpt_lib.remove(old)

    def try_resume(self) -> bool:
        path = self._latest()
        if path is None:
            return False
        like = self.init_state(self.model.init(self.seed, self.device))
        try:
            state, extra = ckpt_lib.restore_state(path, like)
        except (KeyError, ValueError):
            # pp packs its state differently: convert pp <-> standard
            state, extra = self._restore_converted(path)
        self.state = self._place(state)
        self._start_iter = int(extra["iteration"]) + 1
        self._salt = int(extra.get("rng_salt", 0))
        self._salt_high = max(self._salt_high, self._salt,
                              int(extra.get("rng_salt_high", 0)))
        self.logger.restore(self._start_iter)
        return True

    def _restore_converted(self, path: str):
        """(state, extra) of a checkpoint in the other layout, converted
        for this run (JAX ``train/trainer.py:419-470``): a standard
        checkpoint packed for a pp run, a pp checkpoint (of any stage
        count) unpacked for another strategy or repacked for this run's
        stage count."""
        from graphical_gan_tpu_torch.parallel import pipeline as pp_lib
        is_pp_run = self.mesh is not None and self.parallel == "pp"
        shapes = ckpt_lib.leaf_shapes(path)
        is_pp_ckpt = "k:packed" in shapes
        run_stages = int(self.mesh.shape["stage"]) if is_pp_run else None
        ckpt_stages = int(shapes["k:packed"][0]) if is_pp_ckpt else None
        if is_pp_ckpt == is_pp_run and ckpt_stages == run_stages:
            raise ValueError(
                f"checkpoint {path!r} does not match the current model "
                "state structure (and is not a pp<->standard format "
                "difference)")
        std_init = make_train_step(self.model)[1]
        if is_pp_ckpt:
            pp_state, extra = ckpt_lib.restore_state(
                path, pp_lib.pp_state_like(self.model, ckpt_stages,
                                           self.device))
            state = pp_lib.train_state_from_pp_state(self.model, pp_state,
                                                     std_init)
        else:
            state, extra = ckpt_lib.restore_state(
                path, std_init(self.model.init(self.seed, self.device)))
        if is_pp_run:
            state = pp_lib.pp_state_from_train_state(self.model, state,
                                                     run_stages)
        return state, extra

    def _rollback(self, iteration: int) -> None:
        """Restore the latest checkpoint after a non-finite cost at
        ``iteration`` and go on from it on salt ``salt_high + 1``; raises
        :class:`DivergenceError` where there is nothing to restore, the
        budget is spent or the checkpoint lies past the divergence."""
        self._rollbacks += 1
        path = self._latest()  # a write in flight is a checkpoint
        msg = (f"divergence guard: non-finite training cost at iteration "
               f"{iteration}; rollback {self._rollbacks}/"
               f"{self.max_rollbacks}")
        if path is None:
            raise DivergenceError(msg + " — no checkpoint to restore")
        if self._rollbacks > self.max_rollbacks:
            raise DivergenceError(msg + " — rollback budget exhausted")
        self._log(msg)
        # the logger holds only values drained before the poisoned window:
        # write them; the retry logs the rolled-back span anew
        self._final_flush()
        self.logger = MetricLogger()
        if not self.try_resume():
            raise DivergenceError(msg + " — restore failed")
        if self._start_iter > iteration + 1:
            raise DivergenceError(
                msg + f" — latest checkpoint ({os.path.basename(path)}) is "
                "ahead of the divergence point; this run directory holds "
                "checkpoints of another run, refusing to roll forward into "
                "them")
        self._salt_high += 1
        self._salt = self._salt_high

    def _final_flush(self) -> None:
        # hooks fire after the window's flush: what they plotted at the last
        # boundary is written here
        if self.rank0 and self.logger.pending:
            self.logger.flush(self.outf, self.logfile,
                              render=self.render_curves)

    # -- loop -----------------------------------------------------------------

    def iteration_seed(self, iteration: int) -> int:
        """The seed of ``iteration``'s stream on the current salt (see the
        module docstring)."""
        if self._salt == 0:
            return (self.seed << 32) + iteration
        return (SALTED_STREAM_BITS + (self.seed << 40) + (self._salt << 32)
                + (self._salt << 24) + iteration)

    def _seed_iteration(self, iteration: int) -> None:
        self.generator.manual_seed(self.iteration_seed(iteration))

    def draw_batches(self, iteration: int):
        """Seed the generator for ``iteration`` and draw its (1+k) batches
        from the resident data."""
        self._seed_iteration(iteration)
        return self.batch_sampler(self.data, self.generator, 1 + self.k,
                                  self.cfg.batch_size)

    def _host_batches(self):
        """The host-fed stream: (1+k) consecutive batches of an endless
        epoch stream, stacked on the host and copied ahead to the device
        (``graphical_gan_tpu/train/trainer.py:352-364, 532-556``)."""
        def stacked():
            def batches():
                while True:
                    for batch in self.train_gen_factory():
                        yield batch[0] if isinstance(batch, tuple) else batch
            gen = batches()
            while True:
                yield tree.stack([next(gen) for _ in range(1 + self.k)])

        return prefetch_to_device(stacked(), size=2, device=self.device)

    # -- dev sweep --------------------------------------------------------------

    def _build_dev(self) -> None:
        batches, seen = [], 0
        for b in self.dev_gen_factory():
            x = b[0] if isinstance(b, tuple) else b
            if seen + tree.nbytes(x) > DEV_RESIDENT_MAX:
                self._log(f"dev sweep: resident subset of {len(batches)} "
                          f"batches (~{seen >> 20} MiB cap)")
                break
            batches.append(x)
            seen += tree.nbytes(x)
        if not batches:
            raise ValueError(f"one dev batch is over {DEV_RESIDENT_MAX} "
                             "bytes")
        self._dev_data = to_device(tree.stack(batches), self.device)

    @torch.no_grad()
    def dev_costs(self, iteration: int):
        """(gen costs, rec costs or None) of the model's ``gen_loss`` over
        the dev batches, as numpy, from one fetch of the stacked costs."""
        if self._dev_data is None:
            self._build_dev()
        gen = self.eval_generator(DEV_SALT, iteration)
        gens, recs = [], []
        for i in range(tree.first_leaf(self._dev_data).shape[0]):
            g, aux = self.model.gen_loss(self.params,
                                         tree.index(self._dev_data, i),
                                         generator=gen)
            gens.append(g.float())
            if "rec_cost" in aux:
                recs.append(aux["rec_cost"].float())
        vals = torch.stack(gens + recs).cpu().numpy()
        return vals[:len(gens)], (vals[len(gens):] if recs else None)

    def _dev_sweep(self, iteration: int) -> None:
        """Reference cadence: every 100 iterations
        (``gan_inference_cifar10.py:456-477``)."""
        gens, recs = self.dev_costs(iteration)
        if recs is not None:
            self.logger.plot("dev rec cost", float(np.mean(recs)))
            self.logger.plot("dev reg cost",
                             float(np.mean(gens) - np.mean(recs)))
        else:
            self.logger.plot("dev gen cost", float(np.mean(gens)))

    # -- loop -------------------------------------------------------------------

    def train(self, iters: Optional[int] = None,
              resume: bool = True) -> Dict[str, float]:
        iters = iters if iters is not None else self.cfg.iters
        fresh = False
        if self.state is None and not (resume and self.try_resume()):
            self.state = self.fresh_state()
            fresh = True
        total = sum(p.numel() for p in
                    self._read_params(self._full_state()).values())
        self._log(f"Total number of parameters {total}")
        if self.max_rollbacks > 0:
            # the guard's anchor: with no checkpoint yet, an early NaN would
            # have nothing to roll back to (ckpt_-1 resumes at iteration 0)
            anchor = self._latest()
            if fresh and anchor is not None:
                raise ValueError(
                    "divergence guard: resume=False would train afresh in "
                    f"a directory that already holds checkpoints "
                    f"({self.outf}); a rollback would restore the old "
                    "run's state. Pass resume=True or use a clean run "
                    "directory.")
            if anchor is None:
                self.save(self._start_iter - 1)

        while True:
            # the host-fed stream restarts at the loader's first epoch after
            # a rollback, as after a restart
            batches = None if self.data is not None else self._host_batches()
            try:
                last = self._loop(iters, batches) if batches is not None \
                    else self._loop_resident(iters)
                break
            except _Diverged as e:
                self._rollback(e.iteration)
            except _PreemptStop as e:
                self.preempted = True
                last = e.metrics
                break
            finally:
                if batches is not None:
                    batches.close()  # release the worker and its batches
        if self._ckpt_writer is not None:
            self._ckpt_writer.join()  # the last save must be on disk
        self._final_flush()
        return last

    def _start_profile(self):
        """Open the trace. The step graph is dropped, so the trace holds
        its warm-up and its capture: the warm-up's kernels keep the ops
        that launched them, which name the groups of the replays' kernels
        (``tools/trace_report.py``), and no replay is traced of a graph
        captured before the trace began (such replays have segfaulted in
        ``CUDAGraph.replay``; PERF.md, Open questions)."""
        from torch.profiler import ProfilerActivity, profile
        self._graph = None
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, record_shapes=True)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, out_dir: str, first: int, last: int):
        """End the trace after the device has run what it holds, and write
        ``<out_dir>/ggan.<first>-<last>.<pid>.<ns>.trace.json.gz``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"ggan.{first}-{last}.{os.getpid()}."
                            f"{time.time_ns()}.trace.json.gz")
        prof.export_chrome_trace(path)
        print(f"profile: iterations {first}-{last} traced to {path}")

    @staticmethod
    def _pend(iteration: int, costs: Dict, pend) -> None:
        """Queue ``iteration``'s logged cost (D's, or G's after iteration
        0), a device scalar, for the next drain: the costs come to the
        host in one copy at a boundary, not every iteration."""
        if "disc_cost" in costs:
            pend.append((iteration, "train disc cost", costs["disc_cost"]))
        elif iteration > 0:
            pend.append((iteration, "train gen cost", costs["gen_cost"]))

    def _drain(self, pend, inject: bool) -> None:
        """Fetch the pending device costs in one copy, check them where the
        guard is on (after ``GGAN_FAULT_NAN_AT``'s poison, where ``inject``)
        and plot them. The guard's verdict is the first non-finite
        iteration of any rank, agreed over the ranks (JAX
        ``train/trainer.py:895-910``)."""
        vals = torch.stack([v.float() for _, _, v in pend]).cpu().numpy()
        hit = [i for i, (it, _, _) in enumerate(pend)
               if it == self._fault_nan_at]
        if inject and hit and not self._fault_fired:
            self._fault_fired = True
            vals[hit[0]] = np.nan
        if self.max_rollbacks:
            bad = min((it for (it, _, _), v in zip(pend, vals)
                       if not np.isfinite(v)), default=None)
            if self._multi():
                from graphical_gan_tpu_torch.parallel.collectives import (
                    all_max)
                worst = all_max(torch.tensor(
                    [-np.inf if bad is None else -float(bad)]),
                    self.mesh.host).item()
                bad = None if worst == -np.inf else int(-worst)
            if bad is not None:
                raise _Diverged(bad)
        for (it, name, _), val in zip(pend, vals.tolist()):
            self.logger.plot_at(name, val, it)
        pend.clear()

    @staticmethod
    def _profile_window():
        """(``GGAN_PROFILE`` dir or None, first traced iteration, end)."""
        first = int(os.environ.get("GGAN_PROFILE_START", "10"))
        return (os.environ.get("GGAN_PROFILE"), first,
                first + int(os.environ.get("GGAN_PROFILE_STEPS", "10")))

    def _loop(self, iters: int, batches) -> Dict[str, float]:
        """The host-fed loop: one iteration at a time (JAX's
        ``_host_loop``)."""
        profile_dir, first, end = self._profile_window()
        pend, last, prof = [], {}, None
        iteration = self._start_iter
        try:
            for iteration in range(self._start_iter, iters):
                if profile_dir and iteration == first:
                    prof = self._start_profile()
                last = self._iteration(iteration, iters, batches, pend)
                if prof is not None and iteration == end - 1:
                    self._stop_profile(prof, profile_dir, first, iteration)
                    prof = None
        finally:
            if prof is not None:  # the run ended or stopped in the window
                self._stop_profile(prof, profile_dir, first, iteration)
        return {k: float(v) for k, v in last.items()}

    def _iteration(self, iteration: int, iters: int, batches, pend):
        """One host-fed iteration and its boundary work; returns its device
        costs. A preemption request stops the run after it
        (``_PreemptStop``); a non-finite drained cost under the guard
        raises ``_Diverged``."""
        t0 = time.time()
        self._seed_iteration(iteration)
        raw = next(batches)
        self.state, last = self.step_fn(self.state, raw, iteration > 0,
                                        self.generator)
        self._pend(iteration, last, pend)
        self.logger.plot("time", time.time() - t0)
        self._close_window(iteration, iters, last, pend)
        return last

    def _close_window(self, iteration: int, iters: int, last: Dict,
                      pend=None) -> None:
        """The boundary work after ``iteration`` (the host-fed loop's
        iteration, the resident loop's window's last), in JAX's order: the
        drain of ``pend`` (the host-fed loop's device costs) where the
        host acts, dev sweep, flush, tick, hooks, checkpoint, and a
        preemption agreed over the ranks."""
        flush = iteration < 5 or iteration % 100 == 99
        ckpt = iteration == iters - 1 or (
            self.checkpoint_every > 0
            and iteration % self.checkpoint_every
            == self.checkpoint_every - 1)
        hooks = [hook for every, hook in self.eval_hooks.items()
                 if iteration % every == every - 1]
        if (flush or ckpt or hooks) and pend:
            self._drain(pend, inject=True)
        if iteration % 100 == 99 and self.dev_gen_factory is not None:
            self.on_rank0(lambda: self._dev_sweep(iteration), full=True)
        if flush and self.rank0:
            self.logger.flush(self.outf, self.logfile,
                              render=self.render_curves)
        self.logger.tick()
        if hooks:
            def run_hooks():
                for hook in hooks:
                    hook(self, iteration)
            self.on_rank0(run_hooks, full=True)
        if ckpt:
            self.save(iteration)
        if self._any_rank(self._preempt.is_set()):
            # the boundary drain's check first: a preemption after a
            # NaN rolls back instead of checkpointing it
            if pend:
                self._drain(pend, inject=False)
            self._preempt_stop(iteration, last)

    # -- the resident path: JAX's chunked loop ------------------------------

    def _next_event(self, done: int, iters: int) -> int:
        """The first boundary after ``done`` iterations at which the host
        acts (JAX ``train/trainer.py:801-811``): the 100 cadence,
        ``checkpoint_every``, the hooks' cadences (a cadence c acts after
        each multiple of c iterations), the early boundaries 1-5 and
        ``iters``."""
        cadences = [100, self.checkpoint_every, *self.eval_hooks]
        nxt = min((done // c + 1) * c for c in cadences if c > 0)
        if done < 5:  # the flush at iterations < 5
            nxt = min(nxt, done + 1)
        return min(nxt, iters)

    def eager_reason(self) -> Optional[str]:
        """Why this Trainer's resident iterations run eagerly, or None,
        where they run as a CUDA graph (``train/graph.py``)."""
        if self._eager:
            return "the eager dispatch was asked for (Trainer._eager)"
        if self.mesh is not None:
            return ("a mesh: its collectives, gloo's among them, are not "
                    "captured")
        if self.data is None:
            return "the host-fed loop: its batches come from the host"
        if self.device.type != "cuda":
            return f"no CUDA graph on {self.device.type}"
        return None

    def eager_iteration(self, it: int, pend) -> Dict[str, torch.Tensor]:
        """Iteration ``it`` on the resident data, seeded, drawn and stepped
        eagerly, its logged cost appended to ``pend``; returns its
        costs."""
        raw = self.draw_batches(it)
        self.state, costs = self.step_fn(self.state, raw, it > 0,
                                         self.generator)
        self._pend(it, costs, pend)
        return costs

    def dispatch(self, start: int, n: int, pend) -> Dict[str, torch.Tensor]:
        """Iterations ``start`` to ``start + n - 1`` on the resident data,
        back to back: each seeded, drawn and stepped as one iteration of
        the loop (a replay of the step graph where :meth:`eager_reason`
        allows it), its logged cost appended to ``pend`` as a device scalar
        (:meth:`_pend`). Nothing is fetched to the host. Returns the last
        iteration's costs."""
        for it in range(start, start + n):
            if self._graph is not None and self._graph.state is not \
                    self.state:
                self._graph = None  # a resume or rollback replaced it
            if self._graph is not None:
                costs = self._graph.run(it, pend)
            elif it > 0 and self.eager_reason() is None:
                self._graph = StepGraph(self)
                costs = self._graph.warm(it, pend)
            else:
                costs = self.eager_iteration(it, pend)
        return costs

    def _loop_resident(self, iters: int) -> Dict[str, float]:
        """Windows between host events (:meth:`_next_event`), each run as
        dispatches of at most ``chunk_size`` iterations, its costs drained
        in one copy (``GGAN_FAULT_NAN_AT`` and the guard per window),
        ``time`` plotted per iteration, then closed by the boundary work
        (JAX ``train/trainer.py:844-945``). A preemption request agreed
        over the ranks after a dispatch ends the window there. On the card
        one dispatch stays in flight, as in JAX (``:865-874``): the host
        waits for the one before it, so it runs at most a dispatch ahead of
        the device (the step graph's replays would otherwise queue the
        whole window before a request is seen)."""
        profile_dir, first, end = self._profile_window()
        cap = 100 if self.chunk_size is None else self.chunk_size
        pend, last, prof, traced = [], {}, None, 0
        it = self._start_iter
        try:
            while it < iters:
                t0, start = time.time(), it
                target = self._next_event(it, iters)
                in_flight = None
                while it < target:
                    n = min(cap, target - it)
                    # the trace opens at the dispatch that holds ``first``
                    # and closes after the one that reaches ``end`` (JAX
                    # :865-891)
                    if profile_dir and prof is None and it <= first < it + n:
                        prof, traced = self._start_profile(), it
                    last = self.dispatch(it, n, pend)
                    it += n
                    if self.device.type == "cuda":
                        if in_flight is not None:
                            in_flight.synchronize()
                        in_flight = torch.cuda.Event()
                        in_flight.record()
                    if prof is not None and it >= end:
                        self._stop_profile(prof, profile_dir, traced, it - 1)
                        prof = None
                    if it < target and self._any_rank(self._preempt.is_set()):
                        target = it
                if pend:
                    self._drain(pend, inject=True)
                dt = (time.time() - t0) / (it - start)
                for g in range(start, it):
                    self.logger.plot("time", dt)
                    if g < it - 1:
                        self.logger.tick()
                self._close_window(it - 1, iters, last)
        finally:
            if prof is not None:  # the run ended or stopped in the trace
                self._stop_profile(prof, profile_dir, traced,
                                   max(traced, it - 1))
        return {k: float(v) for k, v in last.items()}
