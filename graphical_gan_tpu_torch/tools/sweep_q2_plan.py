"""Times every plan Q2's ``tma`` route could run at the cifar10 int8
sampler's four layers against the one :func:`ops.kernels.quant.q2_plan`
picks, with the ``mma`` route beside them.

    python -m graphical_gan_tpu_torch.tools.sweep_q2_plan [--batches 8 64 256]
        [--dtype float32] [--out FILE]

Per batch and layer the candidates vary what the plan chooses: the tile
(BM 64 or 128; BN from 64, or the layer's own N tile where it is
narrower, up to 128), the ring's stages (2-4) and the K splits (1 up to
one wave of blocks). Each candidate's int32 sums are held to the plain
version's (equal, or the candidate is reported and not timed); its
dequantized output (``--dtype``) is timed with CUDA events over inputs
rotated out of L2 (``tools/timing.py``). One JSON line per layer: the
chosen plan's ms, the best candidate's, their ratio, the ``mma`` route's ms
and the five fastest candidates (``--out`` writes every candidate), with
the card's ``nvidia-smi --query-gpu=name,power.limit`` line. Runs on the
card; without one it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Sequence

import numpy as np
import torch

from graphical_gan_tpu_torch.core.device import resolve_device, set_numerics
from graphical_gan_tpu_torch.ops.kernels import quant as kq
from graphical_gan_tpu_torch.tools.bench_conv_kernel import card_line

# (layer, x's H, W, Cin per row, KH = KW, Cout, pads): cifar10 wali-gp's
# int8 sampler (DIM 64, z 128); the deconvs as their phase convs
SHAPES = [("Generator.Input", (1, 1, 128), 1, 4096, ((0, 0), (0, 0))),
          ("Generator.2", (4, 4, 256), 3, 512, ((1, 1), (1, 1))),
          ("Generator.3", (8, 8, 128), 3, 256, ((1, 1), (1, 1))),
          ("Generator.5", (16, 16, 64), 3, 12, ((1, 1), (1, 1)))]
BATCHES = (8, 64, 256)
TILE_BN = kq.Q2_BN                 # csrc/quant_tma.cu: launch_tile
SMEM_MAX = 232448                  # dynamic shared memory of a block


def smem_bytes(p: kq.Q2Plan, out_dtype: torch.dtype) -> int:
    """csrc/quant_tma.cu: smem_bytes."""
    pitch = p.bn * 2 + 16 if out_dtype == torch.bfloat16 else p.bn * 4 + 32
    return 128 + 1024 + max(p.stages * (p.bm + p.bn) * p.bk, p.bm * pitch)


def candidates(p: kq.Q2Plan, out_dtype: torch.dtype) -> List[kq.Q2Plan]:
    """The tma plans that differ from ``p`` in tile, stages or splits;
    ``p`` is one of them."""
    lo = min(64, kq.n_tile(p.n))
    bns = [bn for bn in TILE_BN if lo <= bn <= max(lo, 2 * p.n)]
    out = []
    for bm in (64, 128):
        for bn in bns:
            tiles = kq.n_tiles(p.m, p.n, bm, bn)
            most = max(1, min(p.steps, kq.SMS // tiles))
            for s in sorted({1, most, max(1, most // 2), p.splits}):
                per = -(-p.steps // s)
                splits = -(-p.steps // per)
                for stages in range(2, kq.MAX_STAGES + 1):
                    c = dataclasses.replace(p, bm=bm, bn=bn, splits=splits,
                                            per=per,
                                            stages=min(stages, per))
                    if smem_bytes(c, out_dtype) <= SMEM_MAX and c not in out:
                        out.append(c)
    if p not in out:
        out.append(p)
    return out


def sweep_shape(name: str, b: int, hwc, k: int, cout: int, pads,
                out_dtype: torch.dtype, device: torch.device, timer,
                seed: int = 0) -> Dict:
    """The record of one layer: per candidate its plan and ms; the chosen
    plan's ms against the best's and the mma route's."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (b,) + hwc, np.int8)
                          ).to(device)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, hwc[2], cout),
                                       np.int8)).to(device)
    factor = torch.from_numpy(rng.random(cout, np.float32) * 1e-4).to(device)
    pf = kq.pack_filter(wq)
    sums = kq.int8_conv_sums_plain(xq, wq, 1, pads)
    chosen = kq.q2_plan(tuple(xq.shape), k, k, cout, 1, pads)
    mma = kq.q2_plan(tuple(xq.shape), k, k, cout, 1, pads, route="mma")

    def call(p):
        def fn(x, p=p):
            return kq.run_plan(x, pf.wk, factor, None, k, k, cout, 1, pads,
                               out_dtype, None, p)
        return fn

    rows = []
    for p in candidates(chosen, out_dtype) + [mma]:
        got = kq.run_plan(xq, pf.wk, None, None, k, k, cout, 1, pads,
                          torch.int32, None, p)
        row = {"route": p.route, "tile": [p.bm, p.bn], "bk": p.bk,
               "stages": p.stages, "splits": p.splits,
               "chosen": p == chosen, "sums_equal": torch.equal(got, sums)}
        row["ms"] = timer(call(p), (xq,)) if row["sums_equal"] else None
        rows.append(row)
    timed = [r for r in rows if r["ms"] is not None and r["route"] == "tma"]
    best = min(timed, key=lambda r: r["ms"])
    mine = next(r for r in rows if r["chosen"])
    keys = ("tile", "bk", "stages", "splits", "ms")
    return {"shape": name, "B": b, "dtype": str(out_dtype).split(".")[1],
            "chosen": {k_: mine[k_] for k_ in keys},
            "best": {k_: best[k_] for k_ in keys},
            "chosen_over_best": (mine["ms"] / best["ms"]
                                 if mine["ms"] else None),
            "mma_ms": rows[-1]["ms"],
            "unequal": [r for r in rows if not r["sums_equal"]],
            "fastest": sorted(timed, key=lambda r: r["ms"])[:5],
            "candidates": rows}


def run(batches: Sequence[int] = BATCHES, dtype: str = "float32",
        device: str = "cuda", timer=None, out: str = None) -> List[Dict]:
    """One record per (batch, layer), each printed as a JSON line without
    its ``candidates`` (``out`` gets the whole records)."""
    dev = resolve_device(device)
    set_numerics()
    if timer is None:
        from graphical_gan_tpu_torch.tools.timing import time_ms

        def timer(fn, args):
            return time_ms(fn, args, 5, 10)
    card = card_line()
    recs = []
    for b in batches:
        for name, hwc, k, cout, pads in SHAPES:
            rec = sweep_shape(name, b, hwc, k, cout, pads,
                              getattr(torch, dtype), dev, timer)
            rec["card"] = card
            print(json.dumps({k_: v for k_, v in rec.items()
                              if k_ != "candidates"}), flush=True)
            recs.append(rec)
    if out:
        with open(out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    return recs


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    return run(args.batches, args.dtype, out=args.out)


if __name__ == "__main__":
    main()
