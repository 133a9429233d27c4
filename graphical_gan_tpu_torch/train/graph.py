"""The resident iteration as a CUDA graph: the port's counterpart of JAX's
jitted, donated step (``graphical_gan_tpu/train/trainer.py:182``) and of the
body of its resident scan (``_chunk_fn``, ``:760-774``): the (1 + k)
batches drawn from the resident data (the trainer's ``batch_sampler``),
the G update, then the k D updates.

A :class:`StepGraph` belongs to one Trainer and to the state it was made
for. The trainer makes it at the first resident iteration with ``do_gen``
(iteration 1 of a fresh run, the first after a resume) that its eager rule
(``Trainer.eager_reason``) lets through, and runs that iteration eagerly on
the graph's capture stream (:meth:`StepGraph.warm`): it builds what the
capture needs first (the kernel library, K1's plans, cuDNN's algorithms,
cuBLAS's workspace for that stream). The next iteration captures the body
once (:meth:`StepGraph.capture`) and every later one replays it. A resume
or a rollback replaces the state's tensors, so the trainer drops the graph
and warms and captures a new one.

Each graphed iteration is three parts (:meth:`StepGraph.run`):

- the host **prologue**: the trainer's generator seeded for the iteration
  (``Trainer.iteration_seed``; the generator is registered with the graph,
  so a replay draws the eager iteration's Philox stream), and with
  ``remat`` each recompute's own generator state seeded at its forward's
  offset (``train/step.py: RematRewinds``; the warm-up records the
  offsets), the step sizes of its Adam updates copied into the graph's
  [1 + k] device tensor, and Adam's ``t`` and the state's ``step``
  counted on the host (``train/step.py: prologue``);
- the **body**, captured at the first run and replayed after it;
- the host **epilogue**: each logged cost copied out of the graph's static
  outputs (one element each) before the next replay overwrites them.

The kernel wrappers count their launches in Python, so the counters see
the eager iterations and the launches the capture records, and no
replay: what a replay runs on the card is read off a device trace
(``ops/kernels: device_launches``). The capture's own count of its
launches (:attr:`StepGraph.launches`) is kept beside it as a cross-check.

A capture error raises: there is no eager fallback, and no counterpart of
JAX's step down to shorter chunks (``:813-842``), since one iteration's
graph has no program-size cap. The checkpoint writer is joined before the
capture, so no other thread copies on the card while it runs.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import torch

from graphical_gan_tpu_torch.ops.kernels import launch_counts


def counted(fn):
    """``(fn(), the launch counts it added)``."""
    before = launch_counts()
    out = fn()
    return out, {n: c - before[n] for n, c in launch_counts().items()
                 if c != before[n]}


class StepGraph:
    """One Trainer's resident iteration with ``do_gen``, for the trainer's
    current ``state``, captured at its first :meth:`run` and replayed at
    every later one."""

    def __init__(self, trainer):
        # weak: the Trainer holds its graph, and a cycle would keep a dead
        # Trainer's graph and its memory pool until the cyclic collector ran
        self._trainer = weakref.ref(trainer)
        self.state = trainer.state
        # the iteration's Adam step sizes, filled by each prologue
        self.lr = torch.zeros(1 + trainer.k, dtype=torch.float32,
                              device=trainer.device)
        self.stream = (torch.cuda.Stream(trainer.device)
                       if trainer.device.type == "cuda" else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.costs: Dict[str, torch.Tensor] = {}
        self.launches: Dict[str, int] = {}
        self.reserved = 0
        # remat's recomputes: (their generator state, their forward's
        # Philox offset), from the warm-up
        self.remat_states: List[Tuple[torch.Generator, int]] = []

    @property
    def tr(self):
        return self._trainer()

    def warm(self, iteration: int, pend) -> Dict[str, torch.Tensor]:
        """``iteration`` run eagerly on the capture stream (the warm-up
        before the capture); returns its costs."""
        tr = self.tr
        if self.stream is None:
            return tr.eager_iteration(iteration, pend)
        rewinds = tr.step_fn.rewinds
        here = torch.cuda.current_stream(tr.device)
        self.stream.wait_stream(here)
        rewinds.offsets = []
        try:
            with torch.cuda.stream(self.stream):
                costs = tr.eager_iteration(iteration, pend)
            self.remat_states = [(tr.generator.clone_state(), offset)
                                 for offset in rewinds.offsets]
        finally:
            rewinds.offsets = None
        here.wait_stream(self.stream)
        return costs

    def prologue(self, iteration: int) -> None:
        tr = self.tr
        tr._seed_iteration(iteration)
        for state, offset in self.remat_states:
            state.manual_seed(tr.iteration_seed(iteration))
            state.set_offset(offset)
        tr.step_fn.prologue(tr.state, True, self.lr)

    def body(self) -> Dict[str, torch.Tensor]:
        tr = self.tr
        raw = tr.batch_sampler(tr.data, tr.generator, 1 + tr.k,
                               tr.cfg.batch_size)
        return tr.step_fn.body(tr.state, raw, True, tr.generator, None,
                               self.lr)

    def epilogue(self, iteration: int, costs: Dict[str, torch.Tensor],
                 pend) -> Dict[str, torch.Tensor]:
        out = {name: c.clone() for name, c in costs.items()}
        self.tr._pend(iteration, out, pend)
        return out

    def capture(self) -> None:
        """Capture the body on the capture stream; the launches it records
        are counted (:attr:`launches`)."""
        tr = self.tr
        if tr._ckpt_writer is not None:
            tr._ckpt_writer.join()
        graph = torch.cuda.CUDAGraph()
        states = [state for state, _ in self.remat_states]
        for gen in [tr.generator] + states:
            graph.register_generator_state(gen)
        rewinds = tr.step_fn.rewinds

        def record():
            with torch.cuda.graph(graph, stream=self.stream):
                return self.body()

        rewinds.states = states
        try:
            self.costs, self.launches = counted(record)
            if rewinds.states:
                raise RuntimeError(
                    f"remat: {len(rewinds.states)} recomputes of the "
                    "warm-up iteration did not recur in the capture")
        finally:
            rewinds.states = None
        self.graph = graph
        self.reserved = torch.cuda.memory_reserved(tr.device)
        tr.captures += 1

    def run(self, iteration: int, pend) -> Dict[str, torch.Tensor]:
        """Iteration ``iteration``: prologue, body (captured at the first
        run, then replayed), epilogue; its costs (copies) are queued on
        ``pend`` and returned."""
        self.prologue(iteration)
        if self.graph is None:
            self.capture()
            self.tr._log(
                f"step graph: iteration {iteration} captured, replayed from "
                f"here on (Trainer.eager_reason: None); capture "
                f"{self.tr.captures} of this Trainer, "
                f"{sum(self.launches.values())} kernel launches captured, "
                f"{self.reserved / 2 ** 20:.1f} MiB reserved")
        self.graph.replay()
        self.tr.replays += 1
        return self.epilogue(iteration, self.costs, pend)
