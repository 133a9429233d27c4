"""Quality-instrument sensitivity (``graphical_gan_tpu/tools/
sensitivity.py``): the learning check of the port.

On the learnable structured family (``data/synthetic.py:
structured_images_labeled``):

1. train the shared ``MetricClassifier`` on the labeled family and record
   its held-out accuracy (the instrument's own validity check);
2. anchor the scale: IS/FID of held-out real data (the perfect generator)
   and of uniform-noise images (the broken one);
3. train cifar10 wali-gp at the published config through the port's
   ``make_train_step`` on the resident family, scoring ``--n-score``
   generator samples at each iteration of the ``--checkpoints`` ladder
   (default 0, 500, 2000, 10000) with the same classifier.

    python -m graphical_gan_tpu_torch.tools.sensitivity --out curve.json

Prints a ``{"progress": ...}`` line per point, then one JSON document with
the JAX tool's keys. Runs on the card unless ``--device cpu`` is given
(then shrink ``--dim``, ``--n-data``, ``--n-score`` and ``--checkpoints``).
The torch random streams differ from JAX's, so a curve matches the JAX
package's in shape and scale, not point for point.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


# the held-out rows drawn after the training rows (the accuracy set and the
# real anchor), and the cap of the noise anchor's size
N_HELDOUT = 4096


def _score(images_hwc, feature_fn, prob_fn, real_mu, real_sigma, splits=10):
    """IS and FID of a sample set under the shared classifier."""
    from graphical_gan_tpu_torch.metrics.fid import (
        frechet_distance, gaussian_stats)
    from graphical_gan_tpu_torch.metrics.inception import get_inception_score

    is_mean, is_std = get_inception_score(list(images_hwc), prob_fn,
                                          splits=splits)
    mu, sigma = gaussian_stats(feature_fn(np.asarray(images_hwc)))
    fid = frechet_distance(real_mu, real_sigma, mu, sigma)
    return {"is_mean": round(float(is_mean), 4),
            "is_std": round(float(is_std), 4),
            "fid": round(float(fid), 4)}


def _to_hwc(flat_int, channels, h, w):
    x = np.asarray(flat_int).reshape(-1, channels, h, w)
    return x.transpose(0, 2, 3, 1).astype(np.float64)


def draw_gan_samples(model, params, n, batch=100, seed=0,
                     quantize_scales=None):
    """``n`` HWC samples in [0, 255] (float32 numpy) from the generator,
    their codes drawn by a generator on the params' device seeded
    ``seed * 7919``; with ``quantize_scales`` (``serve.quantize.
    calibrate``) through the int8 serving path."""
    from graphical_gan_tpu_torch.runs.gan_inference import sample_images
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 7919)
    sample = None
    if quantize_scales:
        from graphical_gan_tpu_torch.serve.quantize import quantized_entry
        fn = quantized_entry(lambda p, s, z: model.sample(p, z),
                             quantize_scales)

        def sample(b):
            return fn(params, 0, torch.randn((b, model.cfg.dim_latent),
                                             generator=gen, device=dev))
    with torch.inference_mode():
        return sample_images(model, params, n, batch, gen, sample)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-data", type=int, default=20000)
    p.add_argument("--n-score", type=int, default=10000,
                   help="samples scored per checkpoint")
    p.add_argument("--checkpoints", default="0,500,2000,10000",
                   help="comma-separated generator iteration ladder")
    p.add_argument("--clf-steps", type=int, default=2000)
    p.add_argument("--clf-dim", type=int, default=32)
    p.add_argument("--dim", type=int, default=None,
                   help="GAN dim override (None = published 64)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--param-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--moment-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient accumulation: microbatches per optimizer "
                        "update (train/step.py: accum_steps)")
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--quantize-final", action="store_true",
                   help="also score the final checkpoint through the int8 "
                        "PTQ serving path (ops/quant.py): the quality delta "
                        "of quantized serving")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    from graphical_gan_tpu_torch.data.ondevice import (
        sample_batches, to_device)
    from graphical_gan_tpu_torch.data.synthetic import (
        structured_images_labeled)
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.metrics.fid import gaussian_stats
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu_torch.train.step import make_train_step

    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics()
    t_start = time.time()
    over = {"compute_dtype": args.compute_dtype}
    for key in ("param_dtype", "moment_dtype", "dim", "batch_size",
                "accum_steps"):
        if getattr(args, key):
            over[key] = getattr(args, key)
    cfg = gan_inference_defaults("cifar10", "wali-gp", **over)
    h, w = cfg.data.image_hw
    c = cfg.data.channels

    # -- structured data and a held-out split --------------------------------
    flat, labels = structured_images_labeled(
        args.n_data + N_HELDOUT, (h, w), c, args.n_classes, seed=args.seed)
    train_flat, train_y = flat[:args.n_data], labels[:args.n_data]
    held_flat = flat[args.n_data:]

    # -- the shared classifier -------------------------------------------------
    clf = MetricClassifier(image_hw=(h, w), channels=c,
                           n_classes=args.n_classes, dim=args.clf_dim,
                           device=dev)
    clf_params = clf.fit(train_flat, train_y, steps=args.clf_steps,
                         seed=args.seed)
    heldout_acc = clf.accuracy(clf_params, held_flat, labels[args.n_data:])
    feature_fn = clf.as_feature_fn(clf_params)
    prob_fn = clf.as_prob_fn(clf_params)

    # -- anchors ---------------------------------------------------------------
    train_hwc = _to_hwc(train_flat[:args.n_score], c, h, w)
    real_mu, real_sigma = gaussian_stats(feature_fn(train_hwc))
    held_hwc = _to_hwc(held_flat[:args.n_score], c, h, w)
    anchors = {
        "heldout_real": _score(held_hwc, feature_fn, prob_fn,
                               real_mu, real_sigma),
        "uniform_noise": _score(
            np.random.RandomState(9).rand(
                min(args.n_score, N_HELDOUT), h, w, c) * 255.0,
            feature_fn, prob_fn, real_mu, real_sigma),
    }

    # -- GAN training with a checkpoint ladder ---------------------------------
    model = GanInferenceModel(cfg)
    k = cfg.critic_iters
    step, init_state = make_train_step(model)
    data = to_device(train_flat.astype(np.uint8), dev)
    gen = torch.Generator(device=dev)
    state = init_state(model.init(args.seed, dev))

    ladder = sorted({int(s) for s in args.checkpoints.split(",")})
    curve = []
    done = 0
    t_train = 0.0
    for target in ladder:
        t0 = time.time()
        while done < target:
            # one generator stream per iteration, as the trainer seeds it
            gen.manual_seed((args.seed << 32) + done)
            raw = sample_batches(data, 1 + k, cfg.batch_size, gen)
            state, metrics = step(state, raw, True, gen)
            done += 1
        if done:
            float(metrics["disc_cost"])  # wait for the card
        t_train += time.time() - t0
        samples = draw_gan_samples(model, state.params, args.n_score,
                                   seed=args.seed)
        entry = {"iter": done,
                 **_score(samples, feature_fn, prob_fn, real_mu,
                          real_sigma)}
        curve.append(entry)
        print(json.dumps({"progress": entry}), flush=True)

    final_int8 = None
    if args.quantize_final:
        from graphical_gan_tpu_torch.serve.quantize import calibrate
        scales = calibrate("gan_inference", model, state.params, 1234,
                           n_batches=4)
        samples_q = draw_gan_samples(model, state.params, args.n_score,
                                     seed=args.seed, quantize_scales=scales)
        final_int8 = {"iter": done,
                      **_score(samples_q, feature_fn, prob_fn, real_mu,
                               real_sigma)}
        print(json.dumps({"final_int8": final_int8}), flush=True)

    rec = {
        "metric": "quality_instrument_sensitivity",
        "classifier_heldout_accuracy": round(float(heldout_acc), 4),
        "anchors": anchors,
        "curve": curve,
        **({"final_int8": final_int8} if final_int8 else {}),
        "n_score": args.n_score,
        "config": {"dim": cfg.dim, "batch_size": cfg.batch_size,
                   "mode": cfg.mode, "compute_dtype": cfg.compute_dtype,
                   "param_dtype": cfg.param_dtype,
                   "moment_dtype": cfg.moment_dtype,
                   "accum_steps": cfg.accum_steps,
                   "n_classes": args.n_classes},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "train_s": round(t_train, 1),
        "wall_s": round(time.time() - t_start, 1),
    }
    text = json.dumps(rec)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return rec


if __name__ == "__main__":
    main()
