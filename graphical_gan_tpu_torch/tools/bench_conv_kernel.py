"""A/B of the K3 conv kernels (``ops/kernels/conv_gemm.py``, K3a taps and
K3b im2col) against the library conv, at the discriminator-stack shapes of
``graphical_gan_tpu/tools/bench_conv_kernel.py``.

    python -m graphical_gan_tpu_torch.tools.bench_conv_kernel \
        [--dtype bfloat16] [--reps 0] [--rounds 5] [--n-inputs 4]

Three arms compute one function, a SAME 5x5 stride-2 conv + bias +
LeakyReLU(0.2): ``library`` (cuDNN's ``F.conv2d`` on channels-last input
padded beforehand, + leaky), ``k3_taps`` and ``k3_im2col``. Each arm is
timed with CUDA events (``tools/timing.py: time_ms``): ``--rounds`` timed
runs of ``--reps`` back-to-back calls (0: enough calls for about 1e12
operations, 20 to 1000; the record's ``reps``), the median run per call.
The calls rotate over ``--n-inputs`` input sets drawn from the seed, and
over copies of them up to twice the L2 cache, so no call reads the inputs
of the call before it from L2. Each arm is held against
``conv_gemm_plain`` (f32 accumulation) by its largest error relative to
max(1, max |ref|), on the first input set. Each K3 arm records its route
(``conv_gemm.route``: the mainloop ``path``, the ``tile`` and the K
``splits``). One JSON line per shape, with the card's ``nvidia-smi
--query-gpu=name,power.limit`` line. Runs on the card; without one it
raises. ``--device cpu`` runs the plain versions at a toy shape on the
host's clock (for its test) and names no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.ops.activations import leaky_relu
from graphical_gan_tpu_torch.ops.kernels.conv_gemm import (
    conv_gemm, conv_gemm_plain, route)
from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads

# (name, B, H=W, Cin, Cout): the cifar10 wali-gp discriminator's convs 2
# and 3 at the published batch 64, and at batch 512
SHAPES = [
    ("disc2", 64, 16, 64, 128),
    ("disc3", 64, 8, 128, 256),
    ("disc2_b512", 512, 16, 64, 128),
    ("disc3_b512", 512, 8, 128, 256),
]
TOY_SHAPES = [("toy", 2, 8, 16, 24)]
ARMS = ("library", "k3_taps", "k3_im2col")
# where --reps is 0: calls per timed run for about this many operations
AUTO_REPS_FLOPS = 1e12
AUTO_REPS = (20, 1000)


def conv_flops(b: int, h: int, cin: int, cout: int) -> int:
    """Operations of the 5x5 stride-2 SAME conv at one shape."""
    oh = -(-h // 2)
    return 2 * b * oh * oh * cout * 25 * cin


def auto_reps(flops: float) -> int:
    """Calls per timed run where ``--reps`` is 0."""
    lo, hi = AUTO_REPS
    return max(lo, min(hi, int(AUTO_REPS_FLOPS // flops)))


def make_timer(device: torch.device, reps: int, rounds: int) -> Callable:
    """``timer(fn, sets)``: the median ms per call over ``rounds`` runs of
    ``reps`` calls rotating over the argument ``sets``, from CUDA events
    on the card (``timing.time_ms``), on the host's clock on the CPU."""
    from graphical_gan_tpu_torch.tools import timing
    if device.type == "cuda":
        return lambda fn, sets: timing.time_ms(fn, sets[0], reps=rounds,
                                               inner=reps, sets=sets)
    return lambda fn, sets: timing.host_ms(fn, sets, reps=rounds, inner=reps)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


def _arms(x, w, bias) -> Dict[str, Tuple[Callable, tuple]]:
    """Per arm, (fn, args): fn(*args) gives the NHWC output."""
    k = w.shape[0]
    lo, hi = same_pads(x.shape[1], k, 2)
    lw, hw = same_pads(x.shape[2], k, 2)
    xpad = F.pad(x.permute(0, 3, 1, 2), (lw, hw, lo, hi)).contiguous(
        memory_format=torch.channels_last)
    wlib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library(xp, wl, b):
        return leaky_relu(F.conv2d(xp, wl, b, stride=2)).permute(0, 2, 3, 1)

    def taps(*a):
        return conv_gemm(*a, variant="taps")

    def im2col(*a):
        return conv_gemm(*a, variant="im2col")
    return {"library": (library, (xpad, wlib, bias)),
            "k3_taps": (taps, (x, w, bias)),
            "k3_im2col": (im2col, (x, w, bias))}


def bench_shape(name: str, b: int, h: int, cin: int, cout: int,
                dtype: torch.dtype, device: torch.device, timer: Callable,
                seed: int = 0, n_inputs: int = 1) -> Dict:
    """The record of one shape: each arm's error against the plain
    reference, its µs and TFLOP/s, the best arm, and how many times faster
    the better K3 variant is than the library. ``timer(fn, sets)`` times
    ``fn`` over the arm's argument sets, one per input set (``n_inputs``
    of x from ``seed``; the filter and bias are shared)."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(device=device, dtype=dtype)

    x = draw((b, h, h, cin))
    w = draw((5, 5, cin, cout), 0.05)
    bias = draw((cout,))
    xs = [x] + [draw((b, h, h, cin)) for _ in range(max(1, n_inputs) - 1)]
    flops = conv_flops(b, h, cin, cout)
    ref = conv_gemm_plain(x, w, bias).float()
    scale = max(1.0, float(ref.abs().max()))
    rec = {"shape": name, "B": b, "H": h, "Cin": cin, "Cout": cout,
           "dtype": str(dtype).split(".")[1], "flops": flops}
    for variant in ("taps", "im2col"):
        p = route(tuple(x.shape), tuple(w.shape), 2, dtype, variant)
        rec[f"k3_{variant}_route"] = {"path": p.path, "tile": [p.bm, p.bn],
                                      "splits": p.splits}
    times = {}
    per_input = [_arms(xi, w, bias) for xi in xs]
    for arm, (fn, args) in per_input[0].items():
        got = fn(*args).float()
        rec[f"{arm}_rel_maxerr"] = float((got - ref).abs().max()) / scale
        t_ms = timer(fn, [arms[arm][1] for arms in per_input])
        times[arm] = t_ms
        rec[f"{arm}_us"] = t_ms * 1e3
        rec[f"{arm}_tflops"] = flops / (t_ms * 1e-3) / 1e12
    rec["best"] = min(times, key=times.get)
    rec["best_k3_vs_library"] = times["library"] / min(times["k3_taps"],
                                                       times["k3_im2col"])
    return rec


def run(shapes: Sequence = SHAPES, dtype: str = "bfloat16",
        device: str = "cuda", timer: Optional[Callable] = None,
        reps: int = 0, rounds: int = 5, n_inputs: int = 4) -> List[Dict]:
    """One record per shape, each printed as a JSON line. ``timer(fn,
    sets)`` replaces :func:`make_timer`'s (``reps``, 0 for
    :func:`auto_reps`, and ``rounds``)."""
    dev = resolve_device(device)
    set_numerics()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    card = card_line() if dev.type == "cuda" else "no card"
    out = []
    for shape in shapes:
        calls = reps or auto_reps(conv_flops(*shape[1:]))
        rec = bench_shape(*shape, getattr(torch, dtype), dev,
                          timer or make_timer(dev, calls, rounds),
                          n_inputs=n_inputs)
        rec.update(reps=calls, device_kind=kind, card=card)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--reps", type=int, default=0,
                   help="calls per timed run, back to back between two "
                        "CUDA events; 0 = auto per shape: enough calls "
                        "for about 1e12 operations (20 to 1000)")
    p.add_argument("--rounds", type=int, default=5,
                   help="timed runs per arm; the record takes their "
                        "median")
    p.add_argument("--n-inputs", type=int, default=4,
                   help="input sets drawn from the seed that the calls "
                        "rotate over (with copies up to twice the L2 "
                        "cache), so no call reads the inputs of the call "
                        "before it from L2")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (a toy shape, host clock)")
    args = p.parse_args(argv)
    shapes = TOY_SHAPES if args.device == "cpu" else SHAPES
    return run(shapes, args.dtype, args.device, reps=args.reps,
               rounds=args.rounds, n_inputs=args.n_inputs)


if __name__ == "__main__":
    main()
