"""Host-side training loop: a subset of ``graphical_gan_tpu/train/
trainer.py``.

It keeps the reference's instruments and cadences: a settings dump
(``config.json`` and ``\\tKEY: value`` lines in ``logfile.txt``), the
parameter count, ``iter N\\ttrain disc cost\\t...`` lines at iterations < 5
and every 100th, and the JAX trainer's improvements the port needs to train
at all: the resident dataset (uploaded once, each iteration's (1+k)
batches gathered on the device), ``ckpt_<iter>.npz`` of the whole
``TrainState`` every ``checkpoint_every`` iterations and at the end (the
last ``CHECKPOINTS_TO_KEEP`` kept), and resume from the latest checkpoint
of the run directory.

Each iteration's random draws come from one ``torch.Generator`` on the
device, seeded from (seed, iteration), so a resumed run draws what an
uninterrupted one would. Left for later slices: preemption handling,
divergence rollback, async and orbax checkpoints, meshes, dev sweeps and
eval hooks (sample grids, quality metrics), the host-fed data path and
multi-iteration dispatch.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, is_dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
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


class Trainer:
    def __init__(self, model, resident_data: np.ndarray, outf: str,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 checkpoint_every: int = 5000):
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
        self.data = to_device(resident_data, self.device)
        self.generator = torch.Generator(device=self.device)
        self.logger = MetricLogger()
        self.state = None
        self._start_iter = 0

    def _log(self, line: str) -> None:
        print(line)
        with open(self.logfile, "a") as f:
            f.write(line + "\n")

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

    def draw_batches(self, iteration: int) -> torch.Tensor:
        """Seed the generator for ``iteration`` and gather its (1+k)
        batches from the resident data."""
        self.generator.manual_seed((self.seed << 32) + iteration)
        return sample_batches(self.data, 1 + self.k, self.cfg.batch_size,
                              self.generator)

    def train(self, iters: Optional[int] = None) -> Dict[str, float]:
        iters = iters if iters is not None else self.cfg.iters
        if self.state is None and not self.try_resume():
            self.state = self.init_state(
                self.model.init(self.seed, self.device))
        total = sum(p.numel() for p in self.state.params.values())
        self._log(f"Total number of parameters {total}")

        pend, last = [], {}
        for iteration in range(self._start_iter, iters):
            t0 = time.time()
            raw = self.draw_batches(iteration)
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
            if (flush or ckpt) and pend:
                vals = torch.stack([v.float() for _, _, v in pend]).cpu()
                for (it, name, _), val in zip(pend, vals.tolist()):
                    self.logger.plot_at(name, val, it)
                pend.clear()
            if flush:
                self.logger.flush(self.logfile)
            self.logger.tick()
            if ckpt:
                self.save(iteration)
        if self.logger.pending:
            self.logger.flush(self.logfile)
        return {k: float(v) for k, v in last.items()}
