"""Times every plan K1 could run at the cifar10 E.1-3 shapes (D.1-3 are the
same) against the one :func:`ops.kernels.fused_conv.plan` picks.

    python -m graphical_gan_tpu_torch.tools.sweep_k1_plan [--batches 8 64 256]

Per dtype, batch and shape, the candidates keep the plan's path and vary
what the plan chooses: the tile (any of the path's tiles, those with
BN = 64 where Cout <= 64) and, in bf16, the K splits (1 up to the most that
leave a split ``MIN_SPLIT_STEPS`` steps); f32 is never split. Each
candidate is timed with CUDA events over inputs rotated out of L2
(``tools/timing.py``) and held against the plain version by its largest
error relative to max(1, max |ref|). One JSON line per shape: the chosen
plan's ms, the best candidate's, their ratio and every candidate, with the
card's ``nvidia-smi --query-gpu=name,power.limit`` line. Runs on the card;
without one it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.ops.kernels import fused_conv
from graphical_gan_tpu_torch.tools.bench_conv_kernel import card_line

# (name, H=W, Cin, Cout, act): cifar10 wali-gp E.1-3, 5x5 stride 2 SAME
SHAPES = [("E.1", 32, 3, 64, "leaky_relu"),
          ("E.2", 16, 64, 128, None),
          ("E.3", 8, 128, 256, None)]
BATCHES = (8, 64, 256)


def candidates(p: fused_conv.Plan) -> List[fused_conv.Plan]:
    """The plans of ``p``'s path that differ from it in tile or splits;
    ``p`` is one of them. Every one covers each K step in one split."""
    tiles = {"fma": fused_conv.F32_TILES, "wgmma": fused_conv.WGMMA_TILES,
             "mma": ((p.bm, p.bn),)}[p.path]
    tiles = [t for t in tiles if p.n > 64 or t[1] == 64]
    steps = -(-p.r // p.bk)
    most = 1 if p.path == "fma" else max(
        1, -(-steps // fused_conv.MIN_SPLIT_STEPS))
    splits = sorted({-(-steps // -(-steps // s)) for s in range(1, most + 1)})
    return [dataclasses.replace(p, bm=bm, bn=bn, splits=s,
                                steps_per_split=-(-steps // s))
            for bm, bn in tiles for s in splits]


def sweep_shape(name: str, b: int, h: int, cin: int, cout: int,
                act: Optional[str], dtype: torch.dtype, device: torch.device,
                timer, seed: int = 0) -> Dict:
    """The record of one shape: per candidate its tile, splits, ms and
    error; the chosen plan's ms against the best's."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, h, cin), np.float32)
                         ).to(device=device, dtype=dtype)
    w = torch.from_numpy(rng.standard_normal((5, 5, cin, cout), np.float32)
                         * 0.05).to(device=device, dtype=dtype)
    bias = torch.from_numpy(rng.standard_normal((cout,), np.float32)).to(
        device=device, dtype=dtype)
    chosen = fused_conv.plan(tuple(x.shape), tuple(w.shape), 2, "SAME",
                             dtype)
    ref = fused_conv.fused_conv2d_bias_act_plain(x, w, bias, 2, "SAME",
                                                 act).float()
    scale = max(1.0, float(ref.abs().max()))
    rows = []
    for p in candidates(chosen):
        def fn(x, w, bias, p=p):
            return fused_conv.run_plan(x, w, bias, 2, "SAME", act, p)
        err = float((fn(x, w, bias).float() - ref).abs().max()) / scale
        rows.append({"tile": [p.bm, p.bn], "splits": p.splits,
                     "chosen": p == chosen, "rel_maxerr": err,
                     "ms": timer(fn, (x, w, bias))})
    best = min(rows, key=lambda r: r["ms"])
    mine = next(r for r in rows if r["chosen"])
    return {"shape": name, "B": b, "dtype": str(dtype).split(".")[1],
            "path": chosen.path, "chosen": {k: mine[k] for k in
                                            ("tile", "splits", "ms")},
            "best": {k: best[k] for k in ("tile", "splits", "ms")},
            "chosen_over_best": mine["ms"] / best["ms"],
            "candidates": rows}


def run(batches: Sequence[int] = BATCHES, device: str = "cuda",
        timer=None) -> List[Dict]:
    """One record per (dtype, batch, shape), each printed as a JSON line."""
    dev = resolve_device(device)
    set_numerics()
    if timer is None:
        from graphical_gan_tpu_torch.tools.timing import time_ms as timer
    card = card_line()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for b in batches:
            for name, h, cin, cout, act in SHAPES:
                rec = sweep_shape(name, b, h, cin, cout, act, dtype, dev,
                                  timer)
                rec["card"] = card
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    args = p.parse_args(argv)
    return run(args.batches)


if __name__ == "__main__":
    main()
