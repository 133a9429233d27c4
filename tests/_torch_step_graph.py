"""The trainer's step graph (``graphical_gan_tpu_torch/train/graph.py``)
run on the CPU, where no CUDA graph exists, for ``test_torch_step_graph*``:
the resident loop as it runs on the card (the eager rule let through, the
warm-up iteration, then each iteration as the graph runner's host
prologue, the body and the host epilogue), with the body run where the
card replays it. Small mnist Trainers (``_torch_trainer.make_trainer``,
dim 8, B 8) over 12 iterations: windows 0-4 alone, 5, 6-7 and 8-11, a
checkpoint at 7 and 11, a hook at 5 and 11.
"""

import numpy as np
import pytest

from _torch_trainer import make_trainer
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.graph import StepGraph
from graphical_gan_tpu_torch.train.trainer import Trainer

ITERS = 12
RESUME_AT = 8   # a window boundary
NAN_AT = 9      # GGAN_FAULT_NAN_AT: inside the window 8-11
COSTS = ("train disc cost", "train gen cost")


def decay(t):
    """The face script's linear decay of Adam's step size
    (``runs/gan_inference.py: decay_scale``) over 20 iterations, so it
    bites inside 12."""
    return max(0.0, 1.0 - t / 20)


def graph_parts(self, iteration, pend):
    """``StepGraph.run`` with the body run in place of the replay."""
    self.prologue(iteration)
    return self.epilogue(iteration, self.body(), pend)


def train(path, mode, graph, iters=ITERS, **kw):
    """A resident mnist ``mode`` Trainer in ``path`` trained to ``iters``;
    with ``graph`` the step graph's parts run from the first iteration with
    ``do_gen``. Returns (trainer, {"warm": iterations warmed, "run":
    iterations run as the graph's parts})."""
    hooks = []
    tr = make_trainer(path, resident=True, mode=mode, checkpoint_every=8,
                      eval_hooks={6: lambda t, i: hooks.append(i)},
                      render_curves=False, **kw)
    seen = {"warm": [], "run": []}
    if not graph:
        tr.train(iters)
        assert tr._graph is None and tr.eager_reason() is not None
        return tr, seen
    warm = StepGraph.warm

    def counted_warm(self, iteration, pend):
        seen["warm"].append(iteration)
        return warm(self, iteration, pend)

    def counted_run(self, iteration, pend):
        seen["run"].append(iteration)
        return graph_parts(self, iteration, pend)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "eager_reason", lambda self: None)
        m.setattr(StepGraph, "warm", counted_warm)
        m.setattr(StepGraph, "run", counted_run)
        tr.train(iters)
    assert tr.captures == 0  # nothing is captured on the CPU
    return tr, seen


def arrays(tr, since=0):
    """Every array of the state and of each checkpoint in the run
    directory, the step, Adam's counts and the logged costs from
    ``since`` on, as numpy."""
    out = {f"state/{k}": v.float().numpy() if v.is_floating_point()
           else v.numpy() for k, v in ckpt_lib.state_leaves(tr.state).items()}
    out["step"] = np.array(tr.state.step)
    for it, path in ckpt_lib.list_checkpoints(tr.outf):
        flat, extra = ckpt_lib.load_raw(path)
        out.update({f"ckpt_{it}/{k}": v for k, v in flat.items()})
        out[f"ckpt_{it}/extra"] = np.array(sorted(extra.items()), dtype=str)
    for name in COSTS:
        out[name] = np.array(sorted(kv for kv in tr.logger.history(
            name).items() if kv[0] >= since))
    return out


def same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def check_scenario(base, mode, scenario, ref, lr_scale=None):
    """The step graph's parts in ``scenario`` ("chunk None", "chunk 1",
    "chunk 3", "resume", "resume graph-eager", "resume eager-graph",
    "rollback") against ``ref``, the eager run of the same tree
    (:func:`reference`), bit for bit."""
    kw = {"lr_scale": lr_scale} if lr_scale else {}
    if scenario.startswith("chunk"):
        chunk = scenario.split()[1]
        kw["chunk_size"] = None if chunk == "None" else int(chunk)
        tr, seen = train(base, mode, True, **kw)
        same_bits(arrays(ref), arrays(tr))
        assert seen == {"warm": [1], "run": list(range(2, ITERS))}
    elif scenario.startswith("resume"):
        # "resume", or across the two dispatches: "resume graph-eager",
        # "resume eager-graph" (the checkpoint format is one)
        first, then = (scenario.split()[1].split("-") if " " in scenario
                       else ("graph", "graph"))
        train(base, mode, first == "graph", iters=RESUME_AT, **kw)
        tr, seen = train(base, mode, then == "graph", **kw)
        assert tr._start_iter == RESUME_AT
        same_bits(arrays(ref, RESUME_AT), arrays(tr, RESUME_AT))
        # a resumed graph Trainer warms and captures anew
        if then == "graph":
            assert seen == {"warm": [RESUME_AT],
                            "run": list(range(RESUME_AT + 1, ITERS))}
    else:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("GGAN_FAULT_NAN_AT", str(NAN_AT))
            tr, seen = train(base, mode, True, chunk_size=3,
                             max_rollbacks=1, **kw)
        assert tr._rollbacks == 1 and tr._salt == 1
        same_bits(arrays(ref), arrays(tr))
        # the window 8-11 ran, its drain saw the poison, ckpt_7 came back:
        # a new graph for the new state, warmed at 8
        assert seen["warm"] == [1, RESUME_AT]
        assert seen["run"] == list(range(2, ITERS)) + list(
            range(RESUME_AT + 1, ITERS))
        assert tr._graph.state is tr.state


def reference(base, mode, kind, lr_scale=None):
    """The eager run of ``kind`` ("plain" or "rollback") that
    :func:`check_scenario` compares with."""
    kw = {"lr_scale": lr_scale} if lr_scale else {}
    if kind == "rollback":
        with pytest.MonkeyPatch.context() as m:
            m.setenv("GGAN_FAULT_NAN_AT", str(NAN_AT))
            tr = train(base, mode, False, max_rollbacks=1, **kw)[0]
        assert tr._rollbacks == 1
        return tr
    return train(base, mode, False, **kw)[0]
