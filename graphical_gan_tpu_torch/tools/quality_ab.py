"""Float against int8 sample quality on one checkpoint
(``graphical_gan_tpu/tools/quality_ab.py``).

``tools/bench_serving.py --quantize int8`` measures what int8 serving
gains in speed; this measures what it costs in sample quality, scoring the
same generator twice under one instrument:

1. the structured labeled pool the run trained on
   (``runs/gan_inference.py: _structured_pool``, the same seed);
2. the metric classifier trained as the run's structured quality hook
   trains it (``make_structured_quality_hook``: dim 32, 2000 steps, seed
   0), so the scores compare with the run's own curve;
3. ``--n-samples`` drawn through the float sampler and through the int8
   sampler (``serve.quantize.calibrate`` on 4 batches from seed 1234, then
   ``ops.quant.quantized``), each scored by IS (the 10-split exp-mean-KL)
   and FID.

    python -m graphical_gan_tpu_torch.tools.quality_ab \\
        --ckpt RUN/ckpt_199999.npz --dataset cifar10 --mode wali-gp \\
        [--device cpu]

Prints the instrument's line, one JSON line per arm and a delta line.
Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.metrics.fid import (
        frechet_distance, gaussian_stats)
    from graphical_gan_tpu_torch.metrics.inception import get_inception_score
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu_torch.runs.gan_inference import _structured_pool
    from graphical_gan_tpu_torch.tools.generate import restore_params
    from graphical_gan_tpu_torch.tools.score_samples import draw_samples

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--mode", default="wali-gp")
    p.add_argument("--n-samples", type=int, default=10000)
    p.add_argument("--clf-steps", type=int, default=2000)
    p.add_argument("--clf-dim", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arms", default="float,int8",
                   help="comma list from {float,int8}")
    p.add_argument("--dim", type=int, default=None,
                   help="GAN dim override (None = published)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    set_numerics()
    overrides = {"dim": args.dim} if args.dim else {}
    cfg = gan_inference_defaults(args.dataset, args.mode, **overrides)
    model = GanInferenceModel(cfg)
    params, _ = restore_params(model, args.ckpt, dev)

    # the shared instrument: the in-run structured hook's
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    train_flat, train_y, eval_flat, eval_y = _structured_pool(
        cfg, seed=args.seed)[2]
    clf = MetricClassifier(image_hw=(h, w), channels=c, n_classes=10,
                           dim=args.clf_dim, device=dev)
    clf_params = clf.fit(train_flat, train_y, steps=args.clf_steps,
                         seed=args.seed)
    acc = float(clf.accuracy(clf_params, eval_flat, eval_y))
    prob_fn = clf.as_prob_fn(clf_params)
    feature_fn = clf.as_feature_fn(clf_params)
    real = np.asarray(train_flat[:args.n_samples]).reshape(-1, c, h, w)
    real = real.transpose(0, 2, 3, 1).astype(np.float64)
    real_mu, real_sigma = gaussian_stats(feature_fn(real))
    print(json.dumps({"instrument": "structured-metric-classifier",
                      "heldout_acc": round(acc, 4)}), flush=True)

    out = {}
    for arm in args.arms.split(","):
        scales = None
        if arm == "int8":
            from graphical_gan_tpu_torch.serve.quantize import calibrate
            scales = calibrate("gan_inference", model, params, 1234,
                               n_batches=4)
        elif arm != "float":
            raise ValueError(f"unknown arm {arm!r}")
        imgs = draw_samples(model, params, args.n_samples,
                            quantize_scales=scales)
        mean, std = get_inception_score(imgs, prob_fn)
        mu, sigma = gaussian_stats(feature_fn(np.asarray(imgs)))
        fid = float(frechet_distance(real_mu, real_sigma, mu, sigma))
        out[arm] = {"is": float(mean), "is_std": float(std), "fid": fid}
        print(json.dumps({"arm": arm, "ckpt": args.ckpt,
                          "inception_score": round(float(mean), 4),
                          "inception_score_std": round(float(std), 4),
                          "fid": round(fid, 4),
                          "n_samples": args.n_samples}), flush=True)
    if "float" in out and "int8" in out:
        delta = {"delta_is": round(out["int8"]["is"] - out["float"]["is"], 4),
                 "delta_fid": round(out["int8"]["fid"] - out["float"]["fid"],
                                    4)}
        print(json.dumps(delta), flush=True)
        out.update(delta)
    out["heldout_acc"] = acc
    return out


if __name__ == "__main__":
    main()
