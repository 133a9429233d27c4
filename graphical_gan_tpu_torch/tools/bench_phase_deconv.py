"""A/B of the stride-2 transposed conv's two routes at the families'
shapes (``graphical_gan_tpu/tools/bench_phase_deconv.py``'s list):

    python -m graphical_gan_tpu_torch.tools.bench_phase_deconv \\
        [--dtype float32,bfloat16] [--shapes gen2,ss3] [--rounds 5] [--k 5]

Per shape (kernel size ``--k``, 5 by default as the families' deconvs,
stride 2, SAME), dtype and pass (``fwd``; ``fwdbwd``, the
forward and the gradients with respect to x and the filter at a fixed
cotangent), three arms:

- ``cudnn``: ``ops/conv.py: conv_transpose``, ``deconv2d``'s default
  route (``F.conv_transpose2d``);
- ``phase``: ``ops/phase_deconv.py: conv_transpose_phase``, one stride-1
  K1 conv to 4·O channels with the bias in its epilogue, then a
  depth-to-space (its backward is K1's);
- ``library``: ``F.conv2d`` + bias on the same stride-1 phase conv (its
  filter built once, the input padded beforehand): the library's time for
  K1's work at that shape.

Each arm is timed with CUDA events around ``--reps`` back-to-back calls in
a synchronized window, the best of ``--rounds`` windows (ms per call).
``k1_bound_ms`` is K1's bound at the phase shape: the operations its conv
needs (taps in the window padding left out) over the card's peak for the
dtype, or its bytes over its HBM rate where that is larger (``tools/
mfu.py``'s tables by the card's name; the H100's at ``--device cpu``). One
JSON line per (shape, dtype, pass), with the card's ``nvidia-smi`` line.
Runs on the card; ``--device cpu`` times the plain versions on the host's
clock at a toy shape (for its test), and names no device metric.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.ops.conv import conv_transpose
from graphical_gan_tpu_torch.ops.phase_deconv import (
    _phase_kernel, conv_transpose_phase)
from graphical_gan_tpu_torch.tools.bench_conv_kernel import card_line
from graphical_gan_tpu_torch.tools.mfu import H100, card_peaks, device_kind

K = 5
# (label, batch, H = W, C_in, C_out): cifar10 wali-gp G (DIM 64, B 64)
# gen2/3/5; celeba G (DIM 32, B 128) face1/4; SSGAN's frame G (B·LEN 800,
# DIM 64) ss2/3/5 (JAX tools/bench_phase_deconv.py:40-49)
SHAPES = [
    ("gen2", 64, 4, 256, 128),
    ("gen3", 64, 8, 128, 64),
    ("gen5", 64, 16, 64, 3),
    ("face1", 128, 4, 256, 128),
    ("face4", 128, 32, 32, 3),
    ("ss2", 800, 8, 256, 128),
    ("ss3", 800, 16, 128, 64),
    ("ss5", 800, 32, 64, 1),
]
TOY_SHAPES = [("toy", 2, 4, 8, 3)]
ARMS = ("cudnn", "phase", "library")


def _valid_taps(n: int, t: int, lo: int) -> int:
    """Taps of a t-wide stride-1 window (low pad ``lo``, n outputs) that
    land inside the input, summed over one axis's outputs."""
    return sum(1 for o in range(n) for j in range(t) if 0 <= o - lo + j < n)


def k1_bound(b: int, h: int, cin: int, cout: int, dtype: str, k: int = K,
             kind: str = H100):
    """(ms, "operations" or "bytes") of K1's phase conv for a k x k
    transpose filter on the card named ``kind``: H x H to 4·cout channels,
    a T x T window, its taps in the window padding left out."""
    big, (pl, _) = _phase_kernel(torch.zeros((k, k, cout, cin)), k)
    t = big.shape[0]
    flops = 2.0 * b * cin * 4 * cout * _valid_taps(h, t, pl) ** 2
    size = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = (b * h * h * cin + b * h * h * 4 * cout + big.numel()
              + 4 * cout) * size
    peak, bw = card_peaks(kind)
    t_ops = flops / peak[dtype] * 1e3
    t_bytes = nbytes / bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def best_ms(fn: Callable[[], object], device: torch.device, reps: int,
            rounds: int) -> float:
    """ms per call of ``fn``: the best of ``rounds`` synchronized windows of
    ``reps`` calls, from CUDA events on the card (the host's clock on the
    CPU)."""
    fn()  # warm: the first call builds the kernels and picks algorithms
    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / reps)
    return best


def _arms(x, w, bias) -> Dict[str, Callable]:
    """Per arm, (forward of (x, filter), filter): the transpose filter for
    cudnn and phase, the stride-1 phase filter (HWIO) for library, whose
    output stays in the phase-channel form [B, H, W, 4·O]."""
    big, (pl, pr) = _phase_kernel(w, int(w.shape[0]))
    b4 = bias.repeat(4)

    def library(xx, ww):
        xp = F.pad(xx.permute(0, 3, 1, 2), (pl, pr, pl, pr))
        out = F.conv2d(xp, ww.to(xx.dtype).permute(3, 2, 0, 1))
        return (out + b4.to(out.dtype).view(1, -1, 1, 1)).permute(
            0, 2, 3, 1)

    return {"cudnn": (lambda xx, ww: conv_transpose(xx, ww, bias), w),
            "phase": (lambda xx, ww: conv_transpose_phase(xx, ww, bias), w),
            "library": (library, big.detach())}


def run(shapes: Sequence, dtypes: Sequence[str], device="cuda",
        reps: int = 10, rounds: int = 5,
        timer: Optional[Callable] = None, k: int = K) -> List[Dict]:
    """Time every arm at ``shapes`` (``SHAPES``' tuples) in ``dtypes``, the
    transpose filters k x k, and print one JSON line per (shape, dtype,
    pass); returns the records."""
    dev = resolve_device(device)
    set_numerics()
    timer = timer or (lambda fn: best_ms(fn, dev, reps, rounds))
    card = card_line() if dev.type == "cuda" else "cpu"
    kind = device_kind(dev) if dev.type == "cuda" else H100
    out = []
    for label, b, h, cin, cout in shapes:
        for dtype in dtypes:
            td = getattr(torch, dtype)
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn((b, h, h, cin), generator=gen, device=dev
                            ).to(td)
            w = torch.randn((k, k, cout, cin), generator=gen,
                            device=dev) * 0.05
            bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
            g = torch.randn((b, 2 * h, 2 * h, cout), generator=gen,
                            device=dev).to(td)
            # the same cotangent in the library arm's phase-channel form
            g4 = g.reshape(b, h, 2, h, 2, cout).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h, h, 4 * cout)
            arms = _arms(x, w, bias)
            bound_ms, bound_by = k1_bound(b, h, cin, cout, dtype, k, kind)
            for which in ("fwd", "fwdbwd"):
                rec = {"metric": "phase_deconv_ab", "shape": label,
                       "batch": b, "hw": h, "cin": cin, "cout": cout,
                       "k": k, "dtype": dtype, "pass": which,
                       "k1_bound_ms": bound_ms, "k1_bound_by": bound_by,
                       "card": card,
                       "clock": "cuda events" if dev.type == "cuda"
                       else "host"}
                for arm in ARMS:
                    fn, filt = arms[arm]
                    if which == "fwd":
                        def call(fn=fn, filt=filt):
                            with torch.no_grad():
                                return fn(x, filt)
                    else:
                        xl = x.detach().requires_grad_(True)
                        wl = filt.detach().requires_grad_(True)
                        cot = g4 if arm == "library" else g

                        def call(fn=fn, xl=xl, wl=wl, cot=cot):
                            y = fn(xl, wl)
                            return torch.autograd.grad(y, (xl, wl), cot)
                    rec[f"{arm}_ms"] = timer(call)
                rec["phase_speedup"] = rec["cudnn_ms"] / rec["phase_ms"]
                rec["k1_vs_library"] = rec["library_ms"] / rec["phase_ms"]
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32,bfloat16",
                   help="comma-separated: float32, bfloat16")
    p.add_argument("--shapes", default=None,
                   help="comma-separated subset of the shape labels")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--k", type=int, default=K,
                   help="kernel size of the transpose filters (default 5, "
                        "the families' deconvs); the phase route's "
                        "stride-1 window and K1's bound follow it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (a toy shape, host clock)")
    args = p.parse_args(argv)
    shapes = TOY_SHAPES if args.device == "cpu" else SHAPES
    if args.shapes:
        shapes = [s for s in shapes if s[0] in args.shapes.split(",")]
    return run(shapes, args.dtype.split(","), args.device, args.reps,
               args.rounds, k=args.k)


if __name__ == "__main__":
    main()
