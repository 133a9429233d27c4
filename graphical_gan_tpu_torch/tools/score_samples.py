"""Sample-quality scoring (``graphical_gan_tpu/tools/score_samples.py``).

Scores a gan_inference checkpoint's samples by the inception-score
protocol under a chosen classifier, and records which one, so two runs
compare only under the same instrument:

    python -m graphical_gan_tpu_torch.tools.score_samples \\
        --ckpt RUN/ckpt_199999.npz --dataset cifar10 --mode ali \\
        [--classifier torch]       # torchvision InceptionV3, local weights
        [--classifier jax --classifier-ckpt clf.npz]
        [--classifier frozen --classifier-ckpt classify_image_graph_def.pb]
        [--quantize int8] [--device cpu]

``--classifier jax`` reads a metric classifier's ``.npz`` in the JAX
package's layout (``tools/train_classifier.py`` of either package writes
one) into ``metrics/classifier.py``; ``--classifier torch`` is
torchvision's InceptionV3 from weights already on the machine
(``metrics/inception.py``); ``--classifier frozen`` is the reference's
frozen Inception-2015 graph read from the ``.pb`` that
``--classifier-ckpt`` names (``metrics/inception_frozen.py``).
``--quantize int8`` draws the samples through the int8 serving path
(``ops/quant.py``), calibrated on 4 batches from seed 1234 as the JAX tool
does. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch


def draw_samples(model, params, n_samples: int, batch: int = 100,
                 quantize_scales=None) -> list:
    """``n_samples`` generator samples as HWC float arrays in [0, 255]
    (the reference protocol); batch i's codes come from a generator seeded
    i on the params' device. ``quantize_scales`` (``serve.quantize.
    calibrate``) draws through the int8 serving path instead."""
    from graphical_gan_tpu_torch.serve.quantize import quantized_entry
    if n_samples <= 0:
        raise ValueError("n_samples must be positive")
    cfg = model.cfg
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    dev = next(iter(params.values())).device

    def sample(p, seed, noise):
        return model.sample(p, noise)
    if quantize_scales:
        sample = quantized_entry(sample, quantize_scales)
    imgs = []
    with torch.inference_mode():
        for i in range(-(-n_samples // batch)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(i)
            noise = torch.randn((batch, cfg.dim_latent), generator=gen,
                                device=dev)
            x = sample(params, i, noise).float()
            x = x * 255.0 if cfg.data.normalization == "unit" \
                else (x + 1.0) * (255.0 / 2)
            x = x.clamp(0, 255).reshape(batch, c, h, w).permute(0, 2, 3, 1)
            imgs.extend(list(x.cpu().numpy()))
    return imgs[:n_samples]


def make_classifier(kind: str, classifier_ckpt: Optional[str], image_hw,
                    channels: int, clf_dim: int = 64, n_classes: int = 10,
                    device="cuda"):
    """(probability function of HWC images, the instrument's identity)."""
    if kind == "frozen":
        from graphical_gan_tpu_torch.metrics.inception_frozen import (
            FrozenInceptionClassifier)
        return (FrozenInceptionClassifier(classifier_ckpt, device),
                f"frozen-inception-2015:{classifier_ckpt}")
    if kind == "torch":
        from graphical_gan_tpu_torch.metrics.inception import (
            TorchInceptionClassifier)
        return (TorchInceptionClassifier(str(device)),
                "torchvision-inception-v3")
    if kind == "jax":
        from graphical_gan_tpu_torch.metrics.classifier import (
            MetricClassifier)
        from graphical_gan_tpu_torch.train import checkpoint
        clf = MetricClassifier(image_hw=image_hw, channels=channels,
                               n_classes=n_classes, dim=clf_dim,
                               device=device)
        flat, _ = checkpoint.load_raw(classifier_ckpt)
        params = checkpoint.params_from_jax(checkpoint.dict_of(flat),
                                            clf.device)
        missing = sorted(set(clf.param_specs()) - set(params))
        if missing:
            raise KeyError(f"{classifier_ckpt!r} lacks the classifier's "
                           f"parameters {missing}")
        return (clf.as_prob_fn(params),
                f"jax-metric-classifier:{classifier_ckpt}")
    raise ValueError(kind)


def main(argv=None) -> dict:
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    from graphical_gan_tpu_torch.metrics.inception import get_inception_score
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu_torch.tools.generate import restore_params

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--mode", default="ali")
    p.add_argument("--n-samples", type=int, default=50000)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--classifier", choices=["torch", "jax", "frozen"],
                   default="torch",
                   help="torch: torchvision InceptionV3 (local weights); "
                        "jax: a metric classifier npz (--classifier-ckpt); "
                        "frozen: the Inception-2015 GraphDef "
                        "(--classifier-ckpt names the .pb)")
    p.add_argument("--classifier-ckpt", default=None)
    p.add_argument("--classifier-dim", type=int, default=64)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--quantize", default=None, choices=["none", "int8"],
                   help="score samples drawn through the int8 PTQ serving "
                        "path (ops/quant.py) instead of the float sampler")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.classifier in ("jax", "frozen") and not args.classifier_ckpt:
        p.error(f"--classifier {args.classifier} requires --classifier-ckpt")

    dev = resolve_device(args.device)
    set_numerics()
    overrides = {"dim": args.dim} if args.dim else {}
    cfg = gan_inference_defaults(args.dataset, args.mode, **overrides)
    model = GanInferenceModel(cfg)
    params, extra = restore_params(model, args.ckpt, dev)
    classifier, ident = make_classifier(
        args.classifier, args.classifier_ckpt, cfg.data.image_hw,
        cfg.data.channels, clf_dim=args.classifier_dim, device=dev)
    scales = None
    if args.quantize == "int8":
        from graphical_gan_tpu_torch.serve.quantize import calibrate
        scales = calibrate("gan_inference", model, params, 1234,
                           n_batches=4)
    imgs = draw_samples(model, params, args.n_samples,
                        quantize_scales=scales)
    mean, std = get_inception_score(imgs, classifier, splits=args.splits)
    rec = {"inception_score": round(float(mean), 4),
           "inception_score_std": round(float(std), 4),
           "classifier": ident, "n_samples": len(imgs), "ckpt": args.ckpt,
           "ckpt_iteration": extra.get("iteration"),
           "quantize": args.quantize or "none"}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
