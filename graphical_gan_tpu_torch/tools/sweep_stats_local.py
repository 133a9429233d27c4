"""A sweep of the split modes' cluster launch plans on the card: K2a's
``bn_stats_local`` (the rank's statistics) and K2c's ``bn_bwd_local`` (the
rank's backward sums), each one thread-block-cluster launch.

    python -m graphical_gan_tpu_torch.tools.sweep_stats_local [--worlds 2 4]

At the cifar10 BN shapes of B=64, one rank's rows over each world size,
f32 and bf16 (inputs from a seeded numpy generator), each kernel (the
forward's first, ``KERNELS``) at the lanes across a tile that its plan picks
(:func:`ops.kernels.fused_norm.bn_stats_local_plan`,
:func:`~ops.kernels.fused_norm.bn_bwd_local_plan`), halved and doubled,
each with clusters of at most 1, 2, 4, 8 and 16 blocks
(:func:`~ops.kernels.fused_norm.local_plan_at`,
:func:`~ops.kernels.fused_norm.bwd_local_plan_at`); each candidate held to
the plain version (the statistics within 1e-9 of 1 + |value|, the sums
within 1e-5 of 1 + each channel's mass Σ|term|) and timed
(``tools/timing.py``). One JSON line per kernel and shape: the chosen
plan's ms, the best candidate's and every candidate, with the card's ``nvidia-smi
--query-gpu=name,power.limit`` line. Runs on the card; without one it
raises.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
from typing import Dict, List, Sequence

B = 64
# (name, rows per image, C): the cifar10 BNs (chip_smoke.bn_shapes)
SHAPES = [("E.BN2", 64, 128), ("E.BN3", 16, 256), ("G.BN1", 1, 4096),
          ("G.BN2", 64, 128), ("G.BN3", 256, 64)]
WORLDS = (2, 4)
CLUSTER_MAXES = (1, 2, 4, 8, 16)
# the kernel the sweep times: (its plan, its plan at given lanes and
# cluster limit), fused_norm's functions by name
KERNELS = {"bn_stats_local": ("bn_stats_local_plan", "local_plan_at"),
           "bn_bwd_local": ("bn_bwd_local_plan", "bwd_local_plan_at")}


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


def bwd_inputs(name: str, dtype, device, seed: int = 21):
    """(g [B·rows, C], scale [C], offset [C], act) of one BN shape from
    numpy: the backward's cotangent, parameters and activation (leaky
    ReLU in E, ReLU in G, as the cifar10 model has them)."""
    import numpy as np
    import torch
    _, per, c = next(s for s in SHAPES if s[0] == name)
    rng = np.random.default_rng(seed + per + c)
    g = rng.standard_normal((B * per, c), np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    offset = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return (torch.from_numpy(g).to(device=device, dtype=dtype),
            torch.from_numpy(scale).to(device),
            torch.from_numpy(offset).to(device),
            "leaky_relu" if name.startswith("E") else "relu")


def candidates(fn, r: int, c: int, dtype,
               kernel: str = "bn_stats_local") -> List:
    """The launch plans of ``kernel`` (a key of ``KERNELS``) for [r, c]
    the sweep times: the chosen one first, then every other (lanes,
    cluster limit) pair."""
    plan, plan_at = (getattr(fn, f) for f in KERNELS[kernel])
    chosen = plan(r, c, dtype)
    threads = chosen.tx * chosen.ty
    out = [chosen]
    for tx in (chosen.tx // 2, chosen.tx, chosen.tx * 2):
        if not 1 <= tx <= threads:
            continue
        for most in CLUSTER_MAXES:
            p = plan_at(r, c, chosen.vec, tx, threads, most)
            if p not in out:
                out.append(p)
    return out


def _case(fn, kernel, name, dtype, dev, w):
    """(launch(plan, *args), args, the plain result, the scale its error is
    divided by, the tolerance) of ``kernel`` at one rank's rows of
    ``name`` over ``w`` ranks."""
    import torch
    x0 = inputs(name, dtype, dev).chunk(w)[0]
    if kernel == "bn_stats_local":
        want = fn.bn_stats_local_plain(x0)
        return (lambda p, a: fn.launch_stats_local(a, p, 0, 1)[0], [x0],
                want, 1.0 + want.abs(), 1e-9)
    g, scale, offset, act = bwd_inputs(name, dtype, dev)
    g0 = g.chunk(w)[0]
    mean, _, inv = fn.bn_stats_plain(x0)
    gz, xhat = fn._gz_xhat(g0, x0, mean, inv, scale, offset, act)
    mass = torch.stack([gz.abs().sum(0), (gz * xhat).abs().sum(0)])
    return (lambda p, a, b: fn.launch_bwd_local(a, b, mean, inv, scale,
                                                offset, act, p, 0, 1)[0],
            [g0, x0],
            fn.bn_bwd_reduce_plain(g0, x0, mean, inv, scale, offset, act),
            1.0 + mass, 1e-5)


def sweep(worlds: Sequence[int] = WORLDS) -> List[Dict]:
    import torch
    from graphical_gan_tpu_torch.core.device import resolve_device
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
    from graphical_gan_tpu_torch.tools.timing import time_ms
    dev = resolve_device("cuda")
    card = card_line()
    out = []
    for kernel, dtype, (name, _, _), w in itertools.product(
            KERNELS, (torch.float32, torch.bfloat16), SHAPES, worlds):
        launch, args, want, scale, tol = _case(fn, kernel, name, dtype, dev,
                                               w)
        r, c = args[-1].shape
        rows = []
        for p in candidates(fn, r, c, dtype, kernel):
            rec = {"tx": p.tx, "cluster": p.cluster, "rows": p.rows,
                   "blocks": p.n_ct * p.cluster}
            try:
                rec["rel_err"] = float(((launch(p, *args) - want).abs()
                                        / scale).max())
                rec["ms"] = time_ms(lambda *a, p=p: launch(p, *a), args)
            except RuntimeError as e:  # a launch the card refuses
                rec["error"] = str(e)[:200]
            rows.append(rec)
        timed = [t for t in rows if "ms" in t]
        best = min(timed, key=lambda t: t["ms"])
        rec = {"kernel": kernel, "shape": name, "B": B, "ranks": w,
               "rank_rows": r, "dtype": str(dtype).split(".")[1],
               "chosen": rows[0], "best": best,
               "chosen_over_best": rows[0]["ms"] / best["ms"],
               "tolerance": tol,
               "all_within_tolerance": all(t.get("rel_err", 1.0) <= tol
                                           for t in timed),
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
