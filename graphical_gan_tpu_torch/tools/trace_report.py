"""Device-time attribution report from a ``torch.profiler`` trace
(``graphical_gan_tpu/tools/trace_report.py``).

    GGAN_PROFILE=/tmp/prof python -m graphical_gan_tpu_torch.runs.gan_inference ...
    python -m graphical_gan_tpu_torch.tools.trace_report /tmp/prof [--iters N]

It parses the newest ``*.trace.json.gz`` that the trainer's profile hook
(``train/trainer.py``, ``GGAN_PROFILE``) or any ``torch.profiler`` export
wrote, takes the device lanes (the CUDA stream lanes: the events of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; a trace without
them, from a CPU run, falls back to the host's ``cpu_op`` lanes, as the JAX
tool falls back to the host executor threads), and computes **self time**
per event, lane by lane: a CPU op's nested ops are subtracted from it;
kernels on one stream do not nest, so their self time is their duration.

Two groupings take the place of XLA's ``hlo_category``:

- **by kernel** (:data:`GROUPS`, :func:`kernel_group`): substrings of the
  kernel's name, the device-time groups of a serving dispatch;
- **by op** (:data:`TRAIN_GROUPS`, :func:`op_group`): the kernel's name
  first, then the ops that launched it. A kernel's launch is the CUDA
  runtime call with its ``correlation`` id; the ops are the ``cpu_op``
  events that enclose that call on its thread, the autograd nodes of a
  backward included (``ConvolutionBackward0``, ``FusedConv2dBiasAct
  Backward``). A kernel of a CUDA graph's replay (the trainer's step
  graph, ``train/graph.py``) has no launching op: its launch is the graph
  launch (``cudaGraphLaunch``), which heads its chain, so it falls in
  K1's, K2's or the copies' group by its name, else in the group that the
  same kernel's eager launches in the trace fell in (the graph's warm-up
  iteration launches them: :func:`groups_by_name`; where one name served
  several groups, the one it spent the most time in), else in "graph
  replay" (a cuDNN conv's implicit GEMM is not taken for a GEMM), and the
  groups still add up to the busy time. The innermost op's ``Input Dims`` (recorded
  where the profiler ran with ``record_shapes``) name the layer a kernel
  serves.

The top ops are rows of (kernel, the ops that launched it, their input
shapes): one cuDNN kernel may serve a deconv's forward and a conv's input
gradient, and each gets its own row.

Output: a table and one JSON line, ``{"metric": "trace_attribution",
...}``, with the busy ms, the groups' shares and the top kernels;
``--iters N`` adds per-iteration figures (the trainer's trace names the
iterations it holds, ``ggan.<first>-<last>.``: :func:`traced_iterations`).
The tool reads a file and runs nothing on a device.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# device-time groups of a dispatch, by substrings of the kernel's name
GROUPS = (("K1 fused_conv", ("conv_k1_",)),
          ("K2a bn_stats", ("bn_stats_fused_kernel",)),
          ("K2b bn_apply", ("bn_apply_kernel",)),
          ("transpose conv (cuDNN)", ("dgrad", "conv", "xmma", "cudnn",
                                      "implicit_gemm", "sm90_")),
          ("matmul", ("gemm", "cutlass", "ampere_", "magma")))

# device-time groups of a training iteration: the kernel's name first, then
# the autograd node or op that launched it
TRAIN_GROUPS = (
    ("K1 forward", ("conv_k1_",), ()),
    ("K2a-b BN forward", ("bn_stats_fused_kernel", "bn_apply_kernel"), ()),
    ("K2c-d BN backward", ("bn_bwd_fused_kernel",), ()),
    ("BN second order (plain)", (), ("_BatchNormActBackwardBackward",)),
    ("memcpy", ("Memcpy", "Memset"), ()),
    # a replay's kernels have no op: the kernel-name groups above, else
    # their name's eager group (groups_by_name), else this
    ("graph replay", (), ("GraphLaunch",)),
    ("optimizer", (), ("aten::_foreach",)),
    ("conv gradients (cuDNN)", (), ("FusedConv2dBiasActBackward",
                                    "ConvolutionBackwardBackward")),
    ("deconv backward", (), ("ConvolutionBackward0",)),
    ("deconv forward", (), ("aten::conv_transpose2d",)),
    ("GEMMs", ("gemm", "cutlass", "ampere_", "sm90_xmma"),
     ("aten::mm", "aten::addmm", "aten::matmul")),
)


def kernel_group(name: str) -> str:
    """The dispatch group of a kernel (or copy) of this name."""
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def op_group(kernel: str, chain: Sequence[str],
             by_name: Optional[Dict[str, str]] = None) -> str:
    """The training group of a kernel named ``kernel`` whose launching ops,
    innermost first, are ``chain``; a graph's replayed kernel, of no name
    group, takes its group in ``by_name`` (:func:`groups_by_name`) where it
    has one."""
    for label, names, ops in TRAIN_GROUPS:
        if any(k in kernel for k in names) or any(
                o in c for o in ops for c in chain):
            if label == "graph replay" and kernel in (by_name or {}):
                return by_name[kernel]
            return label
    return "other"


def groups_by_name(rows) -> Dict[str, str]:
    """{kernel name: training group} from ``rows`` of (kernel name, its
    launching ops innermost first, device µs): for each name that was
    launched other than by a graph's replay, the group those launches
    spent the most time in (:func:`op_group`)."""
    spent: Dict[Tuple[str, str], float] = defaultdict(float)
    for name, chain, us in rows:
        if not any("GraphLaunch" in c for c in chain):
            spent[(name, op_group(name, chain))] += us
    best: Dict[str, Tuple[str, float]] = {}
    for (name, group), us in spent.items():
        if us > best.get(name, ("", -1.0))[1]:
            best[name] = (group, us)
    return {name: group for name, (group, _) in best.items()}


def device_rows(prof) -> List[Tuple[str, List[str], float]]:
    """(kernel name, launching ops innermost first, device µs) of every
    device event of a finished ``torch.profiler`` session, from its events
    in memory. The device time of a name that no op's launches account
    for (a graph's replay: its launch lies in no op) is one row whose
    chain is the graph launch."""
    from torch.autograd import DeviceType
    rows, claimed = [], defaultdict(float)
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or []
        if ev.device_type != DeviceType.CPU or not kernels:
            continue
        chain, q = [], ev
        while q is not None:
            chain.append(q.name)
            q = q.cpu_parent
        for k in kernels:
            rows.append((k.name, chain, k.duration))
            claimed[k.name] += k.duration
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        rest = _device_us(ev) - claimed.get(ev.key, 0.0)
        if rest > 1e-3:
            rows.append((ev.key, ["cudaGraphLaunch"], rest))
    return rows


def _device_us(ev) -> float:
    """An averaged device event's self device µs (the attribute's name
    changed across PyTorch releases)."""
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def kernel_counts(prof) -> Dict[str, int]:
    """{device kernel name: executions} of a finished ``torch.profiler``
    session: eager launches and a graph's replays alike."""
    from torch.autograd import DeviceType
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type != DeviceType.CPU}


def profile_train(tr, n: int, by_name: Optional[Dict[str, str]] = None):
    """(device busy / wall time, device ms per iteration, device ms per
    iteration by :func:`op_group`, the largest kernels, the host's ops per
    iteration and the ops that take the most host time) over ``n`` Trainer
    iterations on the card, run as the trainer runs them (its dispatch:
    the step graph's replays where ``Trainer.eager_reason`` allows them),
    under ``torch.profiler``, read from its events in memory (no trace
    file); the profiler's own cost inflates the host times. ``by_name``
    groups replayed kernels (:func:`groups_by_name`, from a session that
    holds the eager launches). Under the step graph the iterations before
    the window, outside it, warm and capture a new graph: no replay is
    profiled of a graph captured before an earlier profiler session (such
    replays have segfaulted in ``CUDAGraph.replay``; PERF.md, Open
    questions)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pend = []
    if tr.eager_reason() is None:
        tr._graph = None
        while tr._graph is None or tr._graph.graph is None:
            tr.dispatch(tr.state.step, 1, pend)
    start = tr.state.step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.dispatch(start, n, pend)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for name, chain, us in device_rows(prof):
        g = op_group(name, chain, by_name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top[name[:90]] = top.get(name[:90], 0.0) + us / 1e3
    averages = prof.key_averages()
    busy_ms = sum(_device_us(ev) / 1e3 for ev in averages
                  if ev.device_type != DeviceType.CPU)
    per_iter = {k: v / n for k, v in sorted(groups.items())}
    top = [[k, v / n] for k, v in sorted(top.items(), key=lambda kv: -kv[1])
           [:10]]
    host = [ev for ev in averages if ev.device_type == DeviceType.CPU]
    host_ops = sum(ev.count for ev in host if ev.key.startswith("aten::")) / n
    host_top = [[ev.key, ev.self_cpu_time_total / 1e3 / n] for ev in sorted(
        host, key=lambda ev: -ev.self_cpu_time_total)[:8]]
    return (busy_ms / wall_ms, busy_ms / n, per_iter, top, host_ops,
            host_top)


def traced_iterations(path: str) -> Optional[int]:
    """How many iterations the trainer's trace under ``path`` holds, from
    its name (``ggan.<first>-<last>.<pid>.<ns>.trace.json.gz``); None for
    another trace."""
    name = os.path.basename(find_trace(path))
    if not name.startswith("ggan."):
        return None
    first, last = name.split(".")[1].split("-")
    return int(last) - int(first) + 1


def find_trace(path: str) -> str:
    """``path`` may be the profile dir, a session dir, or the trace file."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(
        path, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *.trace.json.gz under {path!r}")
    return hits[-1]


def _load(trace_file: str) -> Dict:
    with gzip.open(trace_file, "rt") as f:
        return json.load(f)


def load_events(trace_file: str, trace: Optional[Dict] = None):
    """(events, process names by pid, thread names by (pid, tid)) of the
    trace file (or of its already parsed ``trace``)."""
    evs = (trace or _load(trace_file))["traceEvents"]
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for e in evs:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            threads[(e["pid"], e.get("tid"))] = e["args"]["name"]
    return evs, procs, threads


def device_lanes(evs) -> Tuple[List[Tuple], str]:
    """((pid, tid) lanes of the op events, "device" or "host"): the CUDA
    stream lanes where the trace has device events, else the lanes of the
    host's ``cpu_op`` events (a CPU run)."""
    for cats, kind in ((DEVICE_CATS, "device"), (("cpu_op",), "host")):
        lanes = sorted({(e["pid"], e.get("tid")) for e in evs
                        if e.get("ph") == "X" and e.get("cat") in cats},
                       key=str)
        if lanes:
            return lanes, kind
    return [], "host"


def self_times(events) -> List[Tuple[dict, float]]:
    """[(event, self_dur_us)] with children's time subtracted.

    Nesting is a PER-LANE property: events on one (pid, tid) lane are
    properly nested complete events, but two lanes (CUDA streams, the host
    thread and the autograd thread) overlap freely, so each lane gets its
    own stack pass; results concatenate."""
    by_lane: Dict[Tuple, List[dict]] = defaultdict(list)
    for e in events:
        by_lane[(e.get("pid"), e.get("tid"))].append(e)
    if len(by_lane) > 1:
        out: List[Tuple[dict, float]] = []
        for lane_events in by_lane.values():
            out.extend(self_times(lane_events))
        return out
    evs = sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    out: List[Tuple[dict, float]] = []
    stack: List[Tuple[dict, float, float]] = []  # (event, end, child_sum)
    for e in evs:
        ts, dur = e["ts"], e.get("dur", 0.0)
        while stack and ts >= stack[-1][1] - 1e-9:
            ev, end, child = stack.pop()
            out.append((ev, ev.get("dur", 0.0) - child))
            if stack:
                stack[-1] = (stack[-1][0], stack[-1][1],
                             stack[-1][2] + ev.get("dur", 0.0))
        stack.append((e, ts + dur, 0.0))
    while stack:
        ev, end, child = stack.pop()
        out.append((ev, ev.get("dur", 0.0) - child))
        if stack:
            stack[-1] = (stack[-1][0], stack[-1][1],
                         stack[-1][2] + ev.get("dur", 0.0))
    return out


def enclosing_ops(evs) -> Dict[int, List[dict]]:
    """For each launch (``cuda_runtime``/``cuda_driver``) and each
    ``cpu_op`` event, keyed by ``id(event)``: the ``cpu_op`` events that
    enclose it on its thread, innermost first (an op is its own first
    entry)."""
    by_lane: Dict[Tuple, List[dict]] = defaultdict(list)
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op",) + LAUNCH_CATS:
            by_lane[(e["pid"], e.get("tid"))].append(e)
    out: Dict[int, List[dict]] = {}
    for lane in by_lane.values():
        # at one start, the longer event encloses; an op before a launch
        lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0),
                                 e.get("cat") != "cpu_op"))
        stack: List[Tuple[dict, float]] = []
        for e in lane:
            while stack and e["ts"] >= stack[-1][1] - 1e-9:
                stack.pop()
            chain = [op for op, _ in reversed(stack)]
            if e.get("cat") == "cpu_op":
                out[id(e)] = [e] + chain
                stack.append((e, e["ts"] + e.get("dur", 0.0)))
            else:
                out[id(e)] = chain
    return out


def launching_ops(evs, kernels) -> Dict[int, List[dict]]:
    """The ops that launched each device event, innermost first, keyed by
    ``id(event)``: through the launch call with the event's ``correlation``
    id (a graph launch itself first, for the kernels of its replay), else
    through the op with its ``External id``."""
    chains = enclosing_ops(evs)
    by_corr, by_ext = {}, {}
    for e in evs:
        args = e.get("args") or {}
        if e.get("ph") != "X":
            continue
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            by_corr[args["correlation"]] = e
        elif e.get("cat") == "cpu_op" and "External id" in args:
            by_ext[args["External id"]] = e
    out = {}
    for k in kernels:
        args = k.get("args") or {}
        launch = by_corr.get(args.get("correlation"))
        if launch is not None:
            chain = chains.get(id(launch), [])
            out[id(k)] = ([launch] + chain if "GraphLaunch" in launch["name"]
                          else chain)
        else:
            op = by_ext.get(args.get("External id"))
            out[id(k)] = chains.get(id(op), []) if op is not None else []
    return out


def _groups(totals: Dict[str, float], counts: Dict[str, int],
            total_us: float, iters: Optional[int]) -> List[Dict]:
    rows = []
    for g, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        row = {"group": g, "ms": round(us / 1e3, 4),
               "share": round(us / total_us, 4) if total_us else 0.0,
               "events": counts[g]}
        if iters:
            row["ms_per_iter"] = round(us / 1e3 / iters, 4)
        rows.append(row)
    return rows


def report(path: str, iters: Optional[int] = None, top: int = 10) -> Dict:
    trace_file = find_trace(path)
    trace = _load(trace_file)
    evs, _, _ = load_events(trace_file, trace)
    lanes, kind = device_lanes(evs)
    cats = DEVICE_CATS if kind == "device" else ("cpu_op",)
    lane_set = set(lanes)
    ops = [e for e in evs
           if e.get("ph") == "X" and e.get("cat") in cats
           and (e["pid"], e.get("tid")) in lane_set]
    if not ops:
        raise ValueError(f"no op events on device lanes of {trace_file!r}")

    attributed = self_times(ops)
    if kind == "device":
        chains = launching_ops(evs, ops)
    else:
        chains = enclosing_ops(evs)
    by_name = groups_by_name(
        (e["name"], [c["name"] for c in chains.get(id(e), [])], us)
        for e, us in attributed)
    by_kernel: Dict[str, float] = defaultdict(float)
    n_kernel: Dict[str, int] = defaultdict(int)
    by_op: Dict[str, float] = defaultdict(float)
    n_op: Dict[str, int] = defaultdict(int)
    # a kernel's rows are split by what launched it: the same cuDNN kernel
    # serves a deconv's forward and a conv's input gradient
    by_launch: Dict[Tuple, float] = defaultdict(float)
    meta: Dict[Tuple, Dict] = {}
    for e, self_us in attributed:
        chain = chains.get(id(e), [])
        names = [c["name"] for c in chain]
        kg, og = (kernel_group(e["name"]),
                  op_group(e["name"], names, by_name))
        by_kernel[kg] += self_us
        n_kernel[kg] += 1
        by_op[og] += self_us
        n_op[og] += 1
        # a kernel's shapes are its launching op's; a host op's its own
        src = e if kind == "host" else (chain[0] if chain else {})
        launched_by = [n for c, n in zip(chain, names) if c is not e][:4]
        dims = (src.get("args") or {}).get("Input Dims")
        key = (e["name"], tuple(launched_by), json.dumps(dims))
        by_launch[key] += self_us
        meta.setdefault(key, {"launched_by": launched_by,
                              "input_dims": dims, "group": og})
    total_us = sum(by_kernel.values())
    top_ops = sorted(by_launch.items(), key=lambda kv: -kv[1])[:top]
    out = {
        "trace": trace_file,
        "lanes": kind,
        # the card's name from the profiler's device properties
        "device_kind": ((trace.get("deviceProperties") or [{}])[0]
                        .get("name", "cuda")) if kind == "device" else "cpu",
        "n_events": len(ops),
        "busy_ms": round(total_us / 1e3, 4),
        "by_kernel": _groups(by_kernel, n_kernel, total_us, iters),
        "by_op": _groups(by_op, n_op, total_us, iters),
        "top_ops": [
            {"op": key[0], "ms": round(us / 1e3, 4),
             **({"ms_per_iter": round(us / 1e3 / iters, 4)} if iters
                else {}),
             **meta[key]}
            for key, us in top_ops],
    }
    if iters:
        out["iters"] = iters
        out["busy_ms_per_iter"] = round(total_us / 1e3 / iters, 4)
    return out


def summary_line(r: Dict) -> Dict:
    """The JSON line of the CLI: the JAX tool's keys (``top_categories``
    holds the kernel groups), the op groups' shares and the top kernels."""
    return {
        "metric": "trace_attribution", "lanes": r["lanes"],
        "device_kind": r["device_kind"], "busy_ms": r["busy_ms"],
        **({"busy_ms_per_iter": r["busy_ms_per_iter"]} if "iters" in r
           else {}),
        "top_categories": {c["group"]: c["share"]
                           for c in r["by_kernel"][:5]},
        "by_op": {c["group"]: c["share"] for c in r["by_op"]},
        "top_ops": [{k: o[k] for k in ("op", "ms", "group", "launched_by",
                                       "input_dims")}
                    for o in r["top_ops"][:3]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="profile dir (GGAN_PROFILE target) or "
                                "trace.json.gz file")
    p.add_argument("--iters", type=int, default=None,
                   help="iterations the trace covers (adds per-iter rows)")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)
    r = report(args.path, iters=args.iters, top=args.top)

    print(f"trace: {r['trace']} ({r['lanes']} lanes)")
    per_iter = f"  ({r['busy_ms_per_iter']} ms/iter)" if args.iters else ""
    print(f"busy: {r['busy_ms']} ms over {r['n_events']} events{per_iter}")
    for title, rows in (("by kernel", r["by_kernel"]), ("by op", r["by_op"])):
        print(f"{title:32s} {'ms':>10s} {'share':>7s} {'events':>7s}")
        for c in rows:
            print(f"  {c['group']:30s} {c['ms']:10.3f} "
                  f"{c['share']*100:6.1f}% {c['events']:7d}")
    print("top ops by self time:")
    for o in r["top_ops"]:
        print(f"  {o['ms']:10.3f} ms  {o['op'][:80]}  <- "
              f"{' < '.join(o['launched_by'])}  {o['input_dims']}")
    print(json.dumps(summary_line(r)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
