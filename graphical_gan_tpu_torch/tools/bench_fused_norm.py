"""A/B of the fused batch norm + activation kernel K2 against the plain
version and the framework's own batch norm (the counterpart of
``graphical_gan_tpu/tools/bench_pallas.py``, at its shapes):

    python -m graphical_gan_tpu_torch.tools.bench_fused_norm \\
        [--dtype float32,bfloat16] [--shapes disc2,gen1]

Per shape ``[rows, channels]`` and dtype, a forward of batch-statistics
BN with the leaky ReLU (eps 1e-5, scale 1, offset 0, inputs U(-1, 1)),
three arms:

- ``kernel``: ``ops/kernels/fused_norm.py: fused_batchnorm_act``, K2a's
  statistics then K2b's apply (``csrc/fused_norm.cu``);
- ``plain``: its plain PyTorch version (``bn_stats_plain`` then
  ``bn_apply_plain``), what the CPU runs;
- ``library``: ``F.batch_norm`` in training mode, then ``F.leaky_relu``.

On the card each arm's ms per call is the median of CUDA-event windows
over inputs rotated out of L2 (``tools/timing.py``); ``bound_ms`` is the
bytes the function must move (x read once, y written once, the scale and
offset) over the card's HBM rate (``tools/mfu.py: PEAK_BW`` by its name;
the H100's at ``--device cpu``). One JSON line per (shape, dtype), with the
card's ``nvidia-smi`` line. ``--device cpu`` times the plain versions on
the host's clock at a toy shape (for its test) and names no device
metric.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.ops.activations import LEAKY_ALPHA
from graphical_gan_tpu_torch.ops.kernels.fused_norm import (
    EPS, bn_apply_plain, bn_stats_plain, fused_batchnorm_act)
from graphical_gan_tpu_torch.tools.bench_conv_kernel import card_line
from graphical_gan_tpu_torch.tools.mfu import H100, card_peaks, device_kind

# (label, (rows, channels)): the JAX tool's 0.5 GB shape and two of
# cifar10's BN shapes at B 64 (bench_pallas.py:37-41)
SHAPES = [
    ("0.5GB", (64 * 64 * 64, 512)),
    ("disc2", (64 * 16 * 16, 128)),
    ("gen1", (64 * 8 * 8, 256)),
]
TOY_SHAPES = [("toy", (256, 16))]
ARMS = ("kernel", "plain", "library")


def bound_ms(rows: int, c: int, itemsize: int, kind: str = H100) -> float:
    """x read once and y written once in the dtype, scale and offset in
    f32, over the memory rate of the card named ``kind``."""
    return (2 * rows * c * itemsize + 2 * 4 * c) / card_peaks(kind)[1] * 1e3


def _arms(scale, offset) -> Dict[str, Callable]:
    def kernel(x):
        return fused_batchnorm_act(x, scale, offset, "leaky_relu", EPS)

    def plain(x):
        mean, _, inv = bn_stats_plain(x, EPS)
        return bn_apply_plain(x, mean, inv, scale, offset, "leaky_relu")

    def library(x):
        y = F.batch_norm(x, None, None, scale.to(x.dtype),
                         offset.to(x.dtype), training=True, eps=EPS)
        return F.leaky_relu(y, LEAKY_ALPHA)

    return {"kernel": kernel, "plain": plain, "library": library}


def host_ms(fn: Callable, x: torch.Tensor, reps: int = 3,
            rounds: int = 3) -> float:
    """ms per call on the host's clock, the best of ``rounds`` windows (a
    CPU run: no device metric)."""
    fn(x)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
    return best


def run(shapes: Sequence, dtypes: Sequence[str], device="cuda"
        ) -> List[Dict]:
    """Time every arm at ``shapes`` in ``dtypes`` and print one JSON line
    per (shape, dtype); returns the records."""
    dev = resolve_device(device)
    set_numerics()
    if dev.type == "cuda":
        from graphical_gan_tpu_torch.tools.timing import time_ms

        def timer(fn, x):
            return time_ms(fn, (x,))
    else:
        timer = host_ms
    card = card_line() if dev.type == "cuda" else "cpu"
    kind = device_kind(dev) if dev.type == "cuda" else H100
    out = []
    for label, (rows, c) in shapes:
        for dtype in dtypes:
            td = getattr(torch, dtype)
            gen = torch.Generator(device=dev).manual_seed(0)
            x = (torch.rand((rows, c), generator=gen, device=dev) * 2 - 1
                 ).to(td)
            scale = torch.ones((c,), device=dev)
            offset = torch.zeros((c,), device=dev)
            arms = _arms(scale, offset)
            rec = {"metric": "fused_bn_act_ab", "shape": label,
                   "rows": rows, "channels": c, "dtype": dtype,
                   "bound_ms": bound_ms(rows, c, x.element_size(), kind),
                   "bound_by": "bytes", "card": card,
                   "clock": "cuda events" if dev.type == "cuda"
                   else "host"}
            with torch.no_grad():
                for arm in ARMS:
                    rec[f"{arm}_ms"] = timer(arms[arm], x)
            rec["kernel_vs_plain"] = rec["plain_ms"] / rec["kernel_ms"]
            rec["kernel_vs_library"] = rec["library_ms"] / rec["kernel_ms"]
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32",
                   help="comma-separated: float32, bfloat16")
    p.add_argument("--shapes", default=None,
                   help="comma-separated subset of the shape labels")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (a toy shape, host clock)")
    args = p.parse_args(argv)
    shapes = TOY_SHAPES if args.device == "cpu" else SHAPES
    if args.shapes:
        shapes = [s for s in shapes if s[0] in args.shapes.split(",")]
    return run(shapes, args.dtype.split(","), args.device)


if __name__ == "__main__":
    main()
