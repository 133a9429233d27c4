"""SSGAN's learning check on the structured digits: moving-MNIST
``local_ep`` at the published config through ``runs/ssgan.run`` on the
``device`` data pipeline, the eval hook once before training and every
``--every`` iterations after, and the fixed dev batch's reconstruction
error (``dev rec l2``) read back from the run's logfile.

    python -m graphical_gan_tpu_torch.tools.ssgan_learn --seed 0 \\
        --outdir result/learn3

Prints one JSON line: the seed, ``dev_rec_l2`` by the logfile's iteration
labels (0 before training; the last at ``--iters``), ``ratio`` (the last
reading over the first), the seconds and the last costs. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict


def dev_rec_readings(text: str) -> Dict[int, float]:
    """{iteration: dev rec l2} of a trainer's logfile lines."""
    out = {}
    for line in text.splitlines():
        parts = line.split("\t")
        if parts[0].startswith("iter ") and "dev rec l2" in parts:
            out[int(parts[0][5:])] = float(
                parts[parts.index("dev rec l2") + 1])
    return out


def run_protocol(seed: int = 0, iters: int = 1000, every: int = 500,
                 outdir: str = "result", compute_dtype: str = "bfloat16",
                 device: str = "cuda", **overrides):
    """(trainer, dev rec l2 readings, last metrics) of one run;
    ``overrides`` are config fields (the tests' small widths)."""
    from graphical_gan_tpu_torch.runs.ssgan import run
    tr, _ = run("moving_mnist", "local_ep", iters=0, data_dir="structured",
                data_pipeline="device", compute_dtype=compute_dtype,
                eval_every=every, checkpoint_every=0, outdir=outdir,
                device=device, seed=seed, **overrides)
    tr.eval_hooks[every](tr, 0)
    metrics = tr.train(iters)
    with open(tr.logfile) as f:
        return tr, dev_rec_readings(f.read()), metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--every", type=int, default=500)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--outdir", default="result")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    _, recs, metrics = run_protocol(args.seed, args.iters, args.every,
                                    args.outdir, args.compute_dtype,
                                    args.device)
    its = sorted(recs)
    print(json.dumps({"seed": args.seed, "dev_rec_l2": recs,
                      "ratio": recs[its[-1]] / recs[its[0]],
                      "seconds": time.perf_counter() - t0,
                      "last": metrics}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
