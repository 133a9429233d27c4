"""A sweep of ``bn_stats_local``'s launch plan on the card (K2a's split
mode, the rank's statistics in one thread-block-cluster launch).

    python -m graphical_gan_tpu_torch.tools.sweep_stats_local [--worlds 2 4]

At the cifar10 BN shapes of B=64, one rank's rows over each world size,
f32 and bf16 (inputs from a seeded numpy generator), ``bn_stats_local`` at
the lanes across a tile that
:func:`ops.kernels.fused_norm.bn_stats_local_plan` picks, halved and
doubled, each with clusters of at most 1, 2, 4, 8 and 16 blocks
(:func:`ops.kernels.fused_norm.local_plan_at`); each candidate held to the
plain version within 1e-9 of 1 + |value| and timed (``tools/timing.py``).
One JSON line per shape: the chosen plan's ms, the best candidate's and
every candidate, with the card's ``nvidia-smi --query-gpu=name,
power.limit`` line. Runs on the card; without one it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Sequence

B = 64
# (name, rows per image, C): the cifar10 BNs (chip_smoke.bn_shapes)
SHAPES = [("E.BN2", 64, 128), ("E.BN3", 16, 256), ("G.BN1", 1, 4096),
          ("G.BN2", 64, 128), ("G.BN3", 256, 64)]
WORLDS = (2, 4)
CLUSTER_MAXES = (1, 2, 4, 8, 16)


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


def inputs(name: str, dtype, device, seed: int = 20):
    """x [B·rows, C] of one BN shape from numpy."""
    import numpy as np
    import torch
    _, per, c = next(s for s in SHAPES if s[0] == name)
    rng = np.random.default_rng(seed + per + c)
    x = rng.standard_normal((B * per, c), np.float32) * 2 + 3
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def candidates(fn, r: int, c: int, dtype) -> List:
    """The launch plans of bn_stats_local for [r, c] the sweep times: the
    chosen one first, then every other (lanes, cluster limit) pair."""
    chosen = fn.bn_stats_local_plan(r, c, dtype)
    threads = chosen.tx * chosen.ty
    out = [chosen]
    for tx in (chosen.tx // 2, chosen.tx, chosen.tx * 2):
        if not 1 <= tx <= threads:
            continue
        for most in CLUSTER_MAXES:
            p = fn.local_plan_at(r, c, chosen.vec, tx, threads, most)
            if p not in out:
                out.append(p)
    return out


def sweep(worlds: Sequence[int] = WORLDS) -> List[Dict]:
    import torch
    from graphical_gan_tpu_torch.core.device import resolve_device
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
    from graphical_gan_tpu_torch.tools.timing import time_ms
    dev = resolve_device("cuda")
    card = card_line()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, _, _ in SHAPES:
            x = inputs(name, dtype, dev)
            for w in worlds:
                x0 = x.chunk(w)[0]
                want = fn.bn_stats_local_plain(x0)
                rows = []
                for p in candidates(fn, *x0.shape, dtype):
                    rec = {"tx": p.tx, "cluster": p.cluster, "rows": p.rows,
                           "blocks": p.n_ct * p.cluster}
                    try:
                        got = fn.launch_stats_local(x0, p, 0, 1)[0]
                        rec["rel_err"] = float(((got - want).abs() / (
                            1.0 + want.abs())).max())
                        rec["ms"] = time_ms(
                            lambda a, p=p: fn.launch_stats_local(a, p, 0, 1),
                            [x0])
                    except RuntimeError as e:  # a launch the card refuses
                        rec["error"] = str(e)[:200]
                    rows.append(rec)
                timed = [r for r in rows if "ms" in r]
                best = min(timed, key=lambda r: r["ms"])
                rec = {"shape": name, "B": B, "ranks": w,
                       "rank_rows": x0.shape[0],
                       "dtype": str(dtype).split(".")[1],
                       "chosen": rows[0], "best": best,
                       "chosen_over_best": rows[0]["ms"] / best["ms"],
                       "all_within_1e-9": all(r.get("rel_err", 1.0) <= 1e-9
                                              for r in timed),
                       "candidates": rows, "card": card}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", type=int, nargs="+", default=list(WORLDS))
    return sweep(p.parse_args(argv).worlds)


if __name__ == "__main__":
    main()
