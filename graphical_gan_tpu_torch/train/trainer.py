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
(uploaded once, each iteration's (1+k) batches gathered on the device) or
the host-fed path ((1+k) consecutive loader batches stacked on the host
and copied ahead by ``data/prefetch.py``), ``ckpt_<iter>.npz`` of the
whole ``TrainState`` every ``checkpoint_every`` iterations and at the end
(the last ``CHECKPOINTS_TO_KEEP`` kept), and resume from the latest
checkpoint of the run directory.

Each iteration's random draws come from one ``torch.Generator`` on the
device, seeded from (seed, iteration), so a resumed run draws what an
uninterrupted one would (on the resident path; the host-fed stream, as in
JAX, restarts at the loader's first epoch). The dev sweep and the hooks
draw from generators seeded from (seed, their salt, iteration)
(``eval_generator``), so a resumed run scores as an uninterrupted one.
Left for later slices: preemption handling, divergence rollback, async and
orbax checkpoints, meshes and multi-iteration dispatch.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, is_dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
from graphical_gan_tpu_torch.data.prefetch import prefetch_to_device
from graphical_gan_tpu_torch.report.plot import MetricLogger
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.step import make_train_step


def make_run_dir(base: str, script: str, tags: Dict) -> str:
    parts = [script] + [f"{k}-{v}" for k, v in tags.items()] \
        + [str(int(time.time()))]
    outf = os.path.join(base, ".".join(parts))
    os.makedirs(outf, exist_ok=True)
    return outf


def dump_settings(outf: str, cfg, logfile: str) -> None:
    d = asdict(cfg) if is_dataclass(cfg) else dict(cfg)
    with open(os.path.join(outf, "config.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)
    with open(logfile, "a") as f:
        for k in sorted(d):
            f.write(f"\t{k.upper()}: {d[k]}\n")


CHECKPOINTS_TO_KEEP = 3
# the dev set stays on the device up to this many bytes; a larger one keeps
# its first batches that fit (``graphical_gan_tpu/train/trainer.py:977-1000``)
DEV_RESIDENT_MAX = 512 * 1024 * 1024
# the salt of the dev sweep's generator; the eval hooks take 2, 3, ...
DEV_SALT = 1


class Trainer:
    """``resident_data`` [N, ...] is uploaded once and sampled on the
    device; with ``resident_data=None`` the host-fed path runs over
    ``train_gen_factory`` (a loader's epoch-generator factory).
    ``eval_hooks`` maps a cadence to ``hook(trainer, iteration)``;
    ``dev_gen_factory`` gives the dev batches the sweep averages over."""

    def __init__(self, model, resident_data: Optional[np.ndarray], outf: str,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 checkpoint_every: int = 5000,
                 eval_hooks: Optional[Dict[int, Callable]] = None,
                 dev_gen_factory: Optional[Callable] = None,
                 train_gen_factory: Optional[Callable] = None):
        if resident_data is None and train_gen_factory is None:
            raise ValueError("the Trainer needs resident_data or, for the "
                             "host-fed path, train_gen_factory")
        self.model = model
        self.cfg = model.cfg
        self.device = resolve_device(device)
        set_numerics()
        self.outf = outf
        os.makedirs(outf, exist_ok=True)
        self.logfile = os.path.join(outf, "logfile.txt")
        dump_settings(outf, self.cfg, self.logfile)
        self.seed = int(seed)
        self.checkpoint_every = checkpoint_every
        self.k = self.cfg.critic_iters
        self.step_fn, self.init_state = make_train_step(model)
        self.data = None if resident_data is None else to_device(
            resident_data, self.device)
        self.train_gen_factory = train_gen_factory
        self.dev_gen_factory = dev_gen_factory
        self._dev_data = None
        self.eval_hooks = {e: h for e, h in (eval_hooks or {}).items()
                           if e > 0}
        self.generator = torch.Generator(device=self.device)
        self.logger = MetricLogger()
        self.state = None
        self._start_iter = 0

    def _log(self, line: str) -> None:
        print(line)
        with open(self.logfile, "a") as f:
            f.write(line + "\n")

    @property
    def params(self):
        """The current parameters (what eval hooks and tools read)."""
        return self.state.params

    def eval_generator(self, salt: int, iteration: int) -> torch.Generator:
        """A generator on the device for an evaluation at ``iteration``,
        seeded from (seed, salt, iteration): salt 0 is never used, so no
        evaluation draws a training iteration's stream."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed << 40) + (salt << 32) + iteration)
        return gen

    # -- checkpoint -----------------------------------------------------------

    def save(self, iteration: int) -> str:
        # rng_* keep the JAX trainer's resume fields: the port's stream is
        # (seed, iteration), so the position is the iteration count
        extra = {"iteration": iteration, "seed": self.seed,
                 "rng_count": iteration + 1, "rng_salt": 0,
                 "rng_salt_high": 0}
        path = ckpt_lib.save_state(
            os.path.join(self.outf, f"ckpt_{iteration}.npz"), self.state,
            extra)
        for _, old in ckpt_lib.list_checkpoints(
                self.outf)[:-CHECKPOINTS_TO_KEEP]:
            os.unlink(old)
        return path

    def try_resume(self) -> bool:
        path = ckpt_lib.latest(self.outf)
        if path is None:
            return False
        like = self.init_state(self.model.init(self.seed, self.device))
        self.state, extra = ckpt_lib.restore_state(path, like)
        self._start_iter = int(extra["iteration"]) + 1
        self.logger.restore(self._start_iter)
        return True

    # -- loop -----------------------------------------------------------------

    def _seed_iteration(self, iteration: int) -> None:
        self.generator.manual_seed((self.seed << 32) + iteration)

    def draw_batches(self, iteration: int) -> torch.Tensor:
        """Seed the generator for ``iteration`` and gather its (1+k)
        batches from the resident data."""
        self._seed_iteration(iteration)
        return sample_batches(self.data, 1 + self.k, self.cfg.batch_size,
                              self.generator)

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
                yield np.stack([next(gen) for _ in range(1 + self.k)])

        return prefetch_to_device(stacked(), size=2, device=self.device)

    # -- dev sweep --------------------------------------------------------------

    def _build_dev(self) -> None:
        batches, seen = [], 0
        for b in self.dev_gen_factory():
            x = b[0] if isinstance(b, tuple) else b
            if seen + x.nbytes > DEV_RESIDENT_MAX:
                self._log(f"dev sweep: resident subset of {len(batches)} "
                          f"batches (~{seen >> 20} MiB cap)")
                break
            batches.append(x)
            seen += x.nbytes
        if not batches:
            raise ValueError(f"one dev batch is over {DEV_RESIDENT_MAX} "
                             "bytes")
        self._dev_data = to_device(np.stack(batches), self.device)

    @torch.no_grad()
    def dev_costs(self, iteration: int):
        """(gen costs, rec costs or None) of the model's ``gen_loss`` over
        the dev batches, as numpy, from one fetch of the stacked costs."""
        if self._dev_data is None:
            self._build_dev()
        gen = self.eval_generator(DEV_SALT, iteration)
        gens, recs = [], []
        for x in self._dev_data:
            g, aux = self.model.gen_loss(self.state.params, x, generator=gen)
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

    def train(self, iters: Optional[int] = None) -> Dict[str, float]:
        iters = iters if iters is not None else self.cfg.iters
        if self.state is None and not self.try_resume():
            self.state = self.init_state(
                self.model.init(self.seed, self.device))
        total = sum(p.numel() for p in self.state.params.values())
        self._log(f"Total number of parameters {total}")

        batches = None if self.data is not None else self._host_batches()
        try:
            last = self._loop(iters, batches)
        finally:
            if batches is not None:
                batches.close()  # release the worker and its queued batches
        # hooks fire after the window's flush: what they plotted at the last
        # boundary is written here
        if self.logger.pending:
            self.logger.flush(self.logfile)
        return last

    def _loop(self, iters: int, batches) -> Dict[str, float]:
        pend, last = [], {}
        for iteration in range(self._start_iter, iters):
            t0 = time.time()
            if batches is None:
                raw = self.draw_batches(iteration)
            else:
                self._seed_iteration(iteration)
                raw = next(batches)
            self.state, last = self.step_fn(self.state, raw, iteration > 0,
                                            self.generator)
            # device scalars are drained in one copy at the next boundary,
            # not fetched every iteration
            if "disc_cost" in last:
                pend.append((iteration, "train disc cost",
                             last["disc_cost"]))
            elif iteration > 0:
                pend.append((iteration, "train gen cost", last["gen_cost"]))
            self.logger.plot("time", time.time() - t0)
            flush = iteration < 5 or iteration % 100 == 99
            ckpt = iteration == iters - 1 or (
                self.checkpoint_every > 0
                and iteration % self.checkpoint_every
                == self.checkpoint_every - 1)
            hooks = [hook for every, hook in self.eval_hooks.items()
                     if iteration % every == every - 1]
            if (flush or ckpt or hooks) and pend:
                vals = torch.stack([v.float() for _, _, v in pend]).cpu()
                for (it, name, _), val in zip(pend, vals.tolist()):
                    self.logger.plot_at(name, val, it)
                pend.clear()
            if iteration % 100 == 99 and self.dev_gen_factory is not None:
                self._dev_sweep(iteration)
            if flush:
                self.logger.flush(self.logfile)
            self.logger.tick()
            for hook in hooks:
                hook(self, iteration)
            if ckpt:
                self.save(iteration)
        return {k: float(v) for k, v in last.items()}
