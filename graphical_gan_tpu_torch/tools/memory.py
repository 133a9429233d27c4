"""Device memory of one training iteration, for capacity planning
(``graphical_gan_tpu/tools/memory.py``).

``tools/mfu.py`` gives the step a FLOP denominator; this gives it a byte
one: the resident train state and data, from their shapes (as JAX's
``_tree_bytes``), and the step's working set on top of them, so an
operator can tell whether a config fits and how much batch or resident
data the card has room for. The knobs that move memory are flags: the
batch size, gradient accumulation (``--accum-steps``) and the low-byte
modes (``--param-dtype`` / ``--moment-dtype bfloat16``).

Method: a ``Trainer`` at the family's published config (``tools/mfu.py:
make_trainer``) runs one warm iteration, then one measured iteration:

- on the card, ``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``, less what was allocated before the
  iteration;
- on the CPU, the peak of the running sum of ``torch.profiler``'s memory
  events (``profile_memory=True``) over the iteration.

``temp_bytes`` is that rise over the live state and data (activations,
gradients, the optimizer's temporaries); ``peak_bytes`` is the state plus
the data plus ``temp_bytes``; ``backend`` says which of the two measured
it. The budget is ``torch.cuda.mem_get_info``'s total on the card.

    python -m graphical_gan_tpu_torch.tools.memory [--family gan]
        [--dtype bfloat16] [--batch-size N] [--accum-steps K]
        [--param-dtype bfloat16] [--moment-dtype bfloat16] [--device cpu]

Prints one JSON line. Runs on ``cuda`` unless ``--device cpu``; without a
card it raises.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import tempfile

import torch

from graphical_gan_tpu_torch.tools.mfu import (
    device_kind, make_trainer, time_train)

_GIB = float(1 << 30)


def _tree_bytes(tree) -> int:
    """Bytes of the tensors in a (nested) dict, list or dataclass tree;
    Python numbers (the port's ``TrainState.step``) hold none."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(_tree_bytes(getattr(tree, f))
                   for f in tree.__dataclass_fields__)
    return 0


def _cpu_rise(fn) -> int:
    """Peak of the running sum of the CPU allocations ``fn`` makes, from
    ``torch.profiler``'s memory events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "memory.trace.json.gz")
        prof.export_chrome_trace(path)
        with gzip.open(path, "rt") as f:
            evs = json.load(f)["traceEvents"]
    mem = sorted((e for e in evs if e.get("name") == "[memory]"
                  and (e.get("args") or {}).get("Device Type") == 0),
                 key=lambda e: e["ts"])
    total = peak = 0
    for e in mem:
        total += e["args"]["Bytes"]
        peak = max(peak, total)
    return peak


def _cuda_rise(fn, device) -> int:
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base


def step_memory(dtype: str = "float32", family: str = "gan",
                data_rows: int = 1024, device="cuda", **overrides) -> dict:
    """The state's, parameters' and resident data's bytes from shapes, and
    one iteration's working set on ``device``."""
    with tempfile.TemporaryDirectory() as outf:
        tr = make_trainer(family, dtype, outf, device, data_rows=data_rows,
                          **overrides)
        # warm: kernel builds, cuDNN plans, lazy state (iteration 0 skips
        # the G update); on the card the measured iteration is the step
        # graph's capture, whose pool holds the iteration's working set
        time_train(tr, 2)
        if tr.device.type == "cuda":
            temp, backend = _cuda_rise(lambda: time_train(tr, 1),
                                       tr.device), "cuda"
        else:
            temp, backend = _cpu_rise(lambda: time_train(tr, 1)), "cpu"
        state = _tree_bytes(tr.state)
        data = _tree_bytes(tr.data)
        out = {"state_bytes": state,
               "param_bytes": _tree_bytes(tr.state.params),
               "data_resident_bytes": data, "data_rows": data_rows,
               "temp_bytes": temp, "peak_bytes": state + data + temp,
               "backend": {"cuda": "cuda max_memory_allocated",
                           "cpu": "cpu profiler memory events"}[backend]}
    return out


def _device_budget(device: torch.device) -> dict:
    budget = torch.cuda.mem_get_info(device)[1] \
        if device.type == "cuda" else None
    return {"device_kind": device_kind(device), "hbm_budget_bytes": budget}


def main(argv=None) -> int:
    from graphical_gan_tpu_torch.core.device import resolve_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="gan",
                   choices=["gan", "gmgan", "ssgan"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dim", type=int, default=None,
                   help="override the model width (smoke/testing)")
    p.add_argument("--accum-steps", type=int, default=None)
    p.add_argument("--param-dtype", default=None)
    p.add_argument("--moment-dtype", default=None)
    p.add_argument("--data-rows", type=int, default=1024,
                   help="resident synthetic-data rows (scale to your real "
                        "dataset size)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    overrides = {k: v for k, v in [
        ("batch_size", args.batch_size), ("dim", args.dim),
        ("accum_steps", args.accum_steps),
        ("param_dtype", args.param_dtype),
        ("moment_dtype", args.moment_dtype)] if v is not None}
    mem = step_memory(args.dtype, args.family, data_rows=args.data_rows,
                      device=dev, **overrides)
    rec = {"metric": "step_memory", "family": args.family,
           "dtype": args.dtype, **overrides, **mem, **_device_budget(dev)}
    if rec["hbm_budget_bytes"]:
        rec["peak_frac_of_hbm"] = rec["peak_bytes"] / rec["hbm_budget_bytes"]
        # rows of resident data that still fit beside the step's live set
        row_bytes = mem["data_resident_bytes"] / max(mem["data_rows"], 1)
        live = mem["peak_bytes"] - mem["data_resident_bytes"]
        rec["resident_rows_headroom"] = int(
            max(0.0, rec["hbm_budget_bytes"] - live) / max(row_bytes, 1))
    for k, v in list(rec.items()):
        if k.endswith("_bytes") and v is not None:
            rec[k.replace("_bytes", "_gib")] = round(v / _GIB, 4)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
