"""Does ``torch.profiler`` crash a CUDA graph's replay without this
package? A reduction of the sequence in which the trainer's step graph
(``train/graph.py``) segfaulted in ``CUDAGraph.replay``: a profiler
session of eager work, graph A captured while other graphs were alive,
those graphs freed, a profiler session that ran no replay of A, then a
profiled replay of A.

    python -m graphical_gan_tpu_torch.tools.graph_profile_repro [--graphs 8]
        [--layers 1] [--cases full port_full ...]

The graphs here hold a small training step (a noise draw from a
registered generator, ``--layers`` convolutions in a chain, a linear
layer, their gradients, an in-place update; B 16, 16x16x64), captured on a side stream as ``torch.cuda.graph``
captures, after two warm-up runs there; in the ``port_*`` cases the
convolution is the port's K1 (``conv2d_bias_act``) and/or a batch
norm through K2a, K2b and K2c+K2d (``fused_batchnorm_act``, the
cooperative launches) follows it. The eager session runs the same step.
Each case runs in a process of its own (a segfault ends only it) and
prints one JSON line, ``{"case", "rc", "seconds", "tail"}``; rc -11 is a
segfault:

- ``full``: the sequence above;
- ``no_early_session``: no profiler session before the captures;
- ``freed_before``: the other graphs freed before A's capture;
- ``kept``: the other graphs never freed;
- ``no_session``: no profiler session between A's capture and its
  profiled replay;
- ``teardown_0``: ``full`` with ``TEARDOWN_CUPTI=0`` (kineto keeps CUPTI
  up between sessions);
- ``recaptured``: ``full`` with A captured again after the session;
- ``port_full``: ``full`` with K1 and the batch norm in the step;
- ``port_k1``, ``port_bn``: ``full`` with K1 alone, with the batch norm
  alone (after a plain convolution);
- ``port_shared_cudart``: ``port_full`` with the kernel library linked
  against the shared CUDA runtime (``-cudart shared``; built into a
  directory of its own), where the library otherwise links its own static
  copy.

Needs a card; the plain cases import nothing of this package but this
module.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

CASES = ("full", "no_early_session", "freed_before", "kept", "no_session",
         "teardown_0", "recaptured", "port_full", "port_k1", "port_bn",
         "port_shared_cudart")


def _graph(seed: int, k1: bool = False, bn: bool = False, layers: int = 1):
    """(graph, its static output, the step run eagerly) of a small
    training step captured on a side stream after two warm-up runs
    there; ``k1`` takes the port's K1 for the convolution, ``bn`` adds the
    port's batch norm after it."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    w = torch.randn(5, 5, 64, 64, device="cuda") * 0.02
    lin = torch.randn(256, 64 * 16 * 16, device="cuda") * 0.01
    bias, scale, offset = (torch.full((64,), v, device="cuda")
                           for v in (0.0, 1.0, 0.0))
    params = [t.requires_grad_() for t in (w, lin, bias, scale, offset)]
    x = torch.randn(16, 16, 16, 64, device="cuda")  # NHWC

    def conv(v):
        if k1:
            from graphical_gan_tpu_torch.ops.kernels import conv2d_bias_act
            return conv2d_bias_act(v, params[0], params[2], 1, "SAME",
                                   "leaky_relu")
        out = F.conv2d(v.permute(0, 3, 1, 2), params[0].permute(3, 2, 0, 1),
                       params[2], padding=2)
        return F.leaky_relu(out, 0.2).permute(0, 2, 3, 1).contiguous()

    def body():
        noise = torch.randn(x.shape, device="cuda", generator=gen)
        h = x + noise
        for _ in range(layers):
            h = conv(h)
        if bn:
            from graphical_gan_tpu_torch.ops.kernels import (
                fused_batchnorm_act)
            h = fused_batchnorm_act(h, params[3], params[4], "relu")
        else:
            h = h * params[3] + params[4]
        loss = (h.flatten(1) @ params[1].t()).square().mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-4)
        return loss.detach()

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=stream):
        out = body()
    return graph, out, body


def _port_build(case: str) -> dict:
    """The ``_graph`` options of ``case``; for ``port_shared_cudart`` the
    kernel library is set to link the shared CUDA runtime, in a directory
    of its own."""
    if not case.startswith("port_"):
        return {}
    from graphical_gan_tpu_torch.ops.kernels import build
    if case == "port_shared_cudart":
        build.ARCH_FLAGS += ["-cudart", "shared"]
        build.NVCC_FLAGS += ["-cudart", "shared"]
        build._cache_dir = os.path.join(build.BUILD_DIR, "shared_cudart")
    build.lib()
    return {"k1": case != "port_bn", "bn": case != "port_k1"}


def run_case(case: str, n_graphs: int, layers: int = 1) -> None:
    """The case's sequence in this process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    opts = {**_port_build(case), "layers": layers}
    if case != "no_early_session":
        _, _, step = _graph(99, **opts)
        with profile(activities=[ProfilerActivity.CUDA]):
            step()
            torch.cuda.synchronize()
        del step
    others = [_graph(100 + i, **opts) for i in range(n_graphs)]
    for other in others:
        other[0].replay()
    del other  # the list holds the only references
    if case == "freed_before":
        del others[:]
        gc.collect()
    a, out, body = _graph(0, **opts)
    for _ in range(3):
        a.replay()
    torch.cuda.synchronize()
    if case != "kept":
        del others[:]
        gc.collect()
    if case != "no_session":
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(3):
                body()  # eager work, no replay of A
            torch.cuda.synchronize()
    if case == "recaptured":
        a, out, body = _graph(0, **opts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            a.replay()
        torch.cuda.synchronize()
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type.name != "CPU")
    print(json.dumps({"replayed": True, "device_events": kernels,
                      "loss": float(out)}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--graphs", type=int, default=8,
                   help="the other graphs captured before A")
    p.add_argument("--layers", type=int, default=1,
                   help="the convolutions of each graph's step")
    p.add_argument("--case", choices=CASES, default=None,
                   help="run one case in this process")
    p.add_argument("--cases", nargs="+", choices=CASES, default=CASES,
                   help="the cases to run, each in a process of its own")
    args = p.parse_args(argv)
    if args.case:
        run_case(args.case, args.graphs, args.layers)
        return 0
    # the package's parent, for the port cases' imports
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for case in args.cases:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        if case == "teardown_0":
            env["TEARDOWN_CUPTI"] = "0"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--case", case,
             "--graphs", str(args.graphs), "--layers", str(args.layers)],
            env=env, capture_output=True,
            text=True, timeout=600)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
        print(json.dumps({"case": case, "graphs": args.graphs,
                          "layers": args.layers, "rc": proc.returncode,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "tail": tail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
