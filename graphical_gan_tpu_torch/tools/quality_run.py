"""bf16-vs-f32 training quality at speed (``graphical_gan_tpu/tools/
quality_run.py``): where the frozen Inception weights and the real
datasets are not on the machine, a comparison of the two dtypes under one
fixed instrument.

Trains the published cifar10 wali-gp config once per dtype, the same seed,
the data resident on the device, through the production path
(``runs/gan_inference.py: run``), then reports per dtype:

- ``disc_cost_windows``: the train disc cost's mean over 10 windows of the
  run (does bf16 track f32?);
- ``params_finite`` / ``losses_finite``: every parameter and the last
  costs finite;
- ``train_throughput_img_per_sec``: (1+k)·B images per iteration over the
  median of the logger's ``time`` from iteration min(100, iters/2) on
  (the first windows hold the kernels' build); ``wall_seconds``;
- ``fid_vs_train``: FID between generated samples and the train rows under
  the port's ``MetricClassifier`` initialised from seed 1234 (a fixed
  random feature space: a relative instrument, identical inputs score
  identically), and ``hermetic_is`` under the same classifier.

``--data-dir`` trains on real CIFAR-10 batches (``data/cifar10.py``).
Samples are drawn from seeded generators on the device (batch i's codes
from seed 10,000 + i), not from the JAX package's keys.

    python -m graphical_gan_tpu_torch.tools.quality_run --iters 10000 \\
        [--dtypes bfloat16 float32] [--device cpu --dim 8]

Prints one JSON line per dtype, then a summary when both ran. Runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _window_means(hist: dict, n_windows: int = 10):
    if not hist:
        return []
    keys = sorted(hist)
    chunks = np.array_split(np.asarray([hist[k] for k in keys]), n_windows)
    return [round(float(np.mean(c)), 4) for c in chunks if len(c)]


def _draw_samples(trainer, model, n: int, batch: int = 100) -> np.ndarray:
    """``n`` generator samples as HWC float32 in [0, 255]; batch i's codes
    from a generator seeded 10,000 + i on the trainer's device."""
    cfg = model.cfg
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    out = []
    with torch.inference_mode():
        for i in range(n // batch):
            gen = torch.Generator(device=trainer.device)
            gen.manual_seed(10_000 + i)
            noise = torch.randn((batch, cfg.dim_latent), generator=gen,
                                device=trainer.device)
            flat = model.sample(trainer.params, noise).float().cpu().numpy()
            x = ((flat + 1.0) * (255.0 / 2)).clip(0, 255)
            out.append(x.reshape(batch, c, h, w).transpose(0, 2, 3, 1))
    return np.concatenate(out, axis=0)


def _train_images_hwc(cfg, resident: np.ndarray, n: int) -> np.ndarray:
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    x = resident[:n].astype(np.float32)
    if cfg.data.normalization not in ("int_pm1", "dequant", "int256_pm1"):
        x = x * 255.0
    return x.reshape(n, c, h, w).transpose(0, 2, 3, 1)


def run_dtype(dtype: str, iters: int, outdir: str, seed: int,
              data_dir=None, device: str = "cuda", **overrides):
    """Train one dtype; returns ``(trainer, record)``."""
    from graphical_gan_tpu_torch.runs import gan_inference

    t0 = time.time()
    trainer, last = gan_inference.run(
        "cifar10", "wali-gp", iters=iters, data_dir=data_dir,
        outdir=outdir, seed=seed, tsne_every=0, inception_every=0,
        sample_every=max(iters // 2, 1),
        checkpoint_every=max(iters // 2, 1), device=device,
        compute_dtype=dtype, **overrides)
    wall = time.time() - t0

    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.params.values())
    losses_finite = all(np.isfinite(v) for v in last.values())

    times = trainer.logger.history("time")
    ts = [times[k] for k in sorted(times) if k >= min(100, iters // 2)]
    imgs_per_iter = (1 + trainer.k) * trainer.cfg.batch_size
    ips = imgs_per_iter / float(np.median(ts)) if ts else float("nan")

    disc_hist = trainer.logger.history("train disc cost")
    return trainer, {
        "dtype": dtype,
        "iters": iters,
        "params_finite": finite,
        "losses_finite": losses_finite,
        "final": {k: round(v, 4) for k, v in last.items()},
        "disc_cost_windows": _window_means(disc_hist),
        "train_throughput_img_per_sec": round(ips, 1),
        "wall_seconds": round(wall, 1),
    }


def main(argv=None):
    from graphical_gan_tpu_torch.core.device import resolve_device
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.metrics.fid import compute_fid
    from graphical_gan_tpu_torch.metrics.inception import get_inception_score

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10000)
    p.add_argument("--outdir", default="result/quality")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--n-metric-samples", type=int, default=10000)
    p.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    p.add_argument("--dim", type=int, default=None,
                   help="model width override (smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    overrides = {"dim": args.dim} if args.dim else {}

    # the fixed shared feature extractor / classifier of the relative
    # metrics
    clf = MetricClassifier(device=dev)
    clf_params = clf.init(1234)
    feature_fn = clf.as_feature_fn(clf_params)
    prob_fn = clf.as_prob_fn(clf_params)

    results = []
    for dtype in args.dtypes:
        trainer, rec = run_dtype(dtype, args.iters, args.outdir, args.seed,
                                 args.data_dir, str(dev), **overrides)
        n = args.n_metric_samples
        samples = _draw_samples(trainer, trainer.model, n)
        train_hwc = _train_images_hwc(trainer.cfg,
                                      trainer.data[:n].cpu().numpy(), n)
        rec["fid_vs_train"] = round(
            compute_fid(list(samples), list(train_hwc), feature_fn), 3)
        mean, std = get_inception_score(list(samples), prob_fn)
        rec["hermetic_is"] = [round(mean, 4), round(std, 4)]
        print(json.dumps(rec), flush=True)
        results.append(rec)

    if len(results) == 2:
        a, b = results
        print("\nsummary: {} vs {}".format(a["dtype"], b["dtype"]))
        print("  FID-vs-train : {:.3f} vs {:.3f}".format(
            a["fid_vs_train"], b["fid_vs_train"]))
        print("  hermetic IS  : {:.3f} vs {:.3f}".format(
            a["hermetic_is"][0], b["hermetic_is"][0]))
        print("  img/s/card   : {:.0f} vs {:.0f}  (speedup {:.2f}x)".format(
            a["train_throughput_img_per_sec"],
            b["train_throughput_img_per_sec"],
            a["train_throughput_img_per_sec"]
            / max(b["train_throughput_img_per_sec"], 1e-9)))
    return results


if __name__ == "__main__":
    main()
