"""Per-family training throughput (``graphical_gan_tpu/tools/
bench_families.py``): the two families ``bench.py`` does not cover, at
their published configs, timed the way ``tools/mfu.py`` times the step.

- gmgan cifar10 local_ep (``gmgan_defaults``: N_COMS 30, B 64), images/s;
- ssgan moving-MNIST local_ep (``ssgan_defaults``: LEN 16, B 50),
  frames/s (images/s times LEN);
- ``ssgan_device``: the same with fresh videos made on the card every
  iteration from a resident digit pool (``data/ondevice_moving_mnist.py``).

Method: a ``Trainer`` over resident random data (50,000 images, 2,000
videos, 50,000 digits), warmed by three iterations (on the card the step
graph's capture among them), then back-to-back iterations of the
Trainer's dispatch bounded by ``torch.cuda.synchronize`` (``tools/mfu.py:
time_train``), best of ``--rounds``; images per iteration are counted as
``bench.py:111`` counts them, (1+k)·B. On the card each record adds
``device_ms`` per iteration and the busy share (device time over wall
time) from one window under ``torch.profiler`` (``tools/trace_report.py:
profile_train``), whose own host cost makes the share a lower bound.

    python -m graphical_gan_tpu_torch.tools.bench_families
        [--families gmgan ssgan ssgan_device] [--dtype bfloat16]
        [--rounds 5] [--iters 20] [--device cpu]

Prints one JSON line per family. Runs on ``cuda`` unless ``--device cpu``
(where no device time is measured); without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from graphical_gan_tpu_torch.tools.mfu import (
    device_kind, family_model, make_trainer, resident_rows, time_train)
from graphical_gan_tpu_torch.tools.trace_report import profile_train

PROFILE_ITERS = 3
DIGITS = 50_000

METRICS = {
    "gmgan": ("gmgan_cifar10_local_ep_train_throughput", "images/sec/chip"),
    "ssgan": ("ssgan_moving_mnist_local_ep_train_throughput",
              "frames/sec/chip"),
    "ssgan_device": ("ssgan_moving_mnist_device_synthesis_train_throughput",
                     "frames/sec/chip"),
}


def _digit_pool(n_classes: int, n: int):
    rng = np.random.RandomState(0)
    return {"digits": rng.rand(n, 28, 28).astype(np.float32),
            "labels": np.eye(n_classes, dtype=np.float32)[
                rng.randint(0, n_classes, size=n)]}


def bench(name: str, dtype: str = "bfloat16", rounds: int = 5,
          iters: int = 20, device="cuda", data_rows=None,
          **overrides) -> dict:
    """The throughput record of ``name`` (a key of :data:`METRICS`)."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    family = "gmgan" if name == "gmgan" else "ssgan"
    kw = dict(overrides)
    if name == "ssgan_device":
        from graphical_gan_tpu_torch.data.ondevice_moving_mnist import (
            make_video_sampler)
        cfg, _ = family_model(family, dtype, **overrides)
        kw.update(data=_digit_pool(cfg.n_classes, data_rows or DIGITS),
                  batch_sampler=make_video_sampler(cfg.seq_len))
    with tempfile.TemporaryDirectory() as outf:
        tr = make_trainer(family, dtype, outf, dev,
                          data_rows=data_rows or resident_rows(family), **kw)
        # warm: kernel builds, cuDNN plans, allocator, the graph's capture
        time_train(tr, 3)
        ms = min(time_train(tr, iters) for _ in range(rounds))
        busy = device_ms = None
        if dev.type == "cuda":
            busy, device_ms = profile_train(tr, PROFILE_ITERS)[:2]
    cfg = tr.cfg
    items = (1 + cfg.critic_iters) * cfg.batch_size \
        * getattr(cfg, "seq_len", 1)
    metric, unit = METRICS[name]
    return {"metric": metric, "value": items / ms * 1e3, "unit": unit,
            "dtype": dtype, "sec_per_iter": ms / 1e3,
            "device_ms": device_ms, "busy_share": busy,
            "device_kind": device_kind(dev)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--families", nargs="+", default=["gmgan", "ssgan"],
                   choices=sorted(METRICS))
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back iterations per timed round")
    p.add_argument("--dim", type=int, default=None,
                   help="override the model width (smoke/testing)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--data-rows", type=int, default=None,
                   help="resident rows (default 50,000 images, 2,000 "
                        "videos, 50,000 digits)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("dim", args.dim),
                                   ("batch_size", args.batch_size))
                 if v is not None}
    out = []
    for name in args.families:
        rec = bench(name, args.dtype, args.rounds, args.iters, args.device,
                    args.data_rows, **overrides)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
