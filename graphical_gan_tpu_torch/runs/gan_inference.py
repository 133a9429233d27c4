"""Training entry point for model family 1 (a subset of
``graphical_gan_tpu/runs/gan_inference.py``):

    python -m graphical_gan_tpu_torch.runs.gan_inference \\
        --dataset mnist|cifar10|svhn|celeba --mode MODE --iters N --outdir D

Every mode of the family trains (``core/config.py: GAN_INFERENCE_MODES``).
Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions then run on the CPU). The data are the JAX loaders' synthetic
fallbacks, resident on the device: without ``--data-dir``, mnist 50,000
images of float32 pixels in [0, 1] (``data/mnist.py: images_unit``),
cifar10 and svhn 50,000 random-pixel images (as ``bench.py`` uses), celeba
``images_int(20000, 12288, 7)`` (``data/celeba.py``), the integer pixels as
uint8; ``--data-dir structured``, the learnable structured family's
20,000-image train pool in the dataset's own convention. Loaders of the
real datasets (the dataset files are not in the repository), eval hooks,
meshes, preemption and the other flags of the JAX entry point come in later
slices.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.core.config import (
    GAN_INFERENCE_MODES, gan_inference_defaults)
from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.trainer import Trainer, make_run_dir


def resident_data(cfg, data_dir: Optional[str]) -> np.ndarray:
    """The training images [N, C*H*W] (flat NCHW order): float32 in [0, 1]
    for mnist (``normalization == 'unit'``), uint8 pixels otherwise."""
    unit = cfg.data.normalization == "unit"
    if data_dir is None:
        if unit:
            return synthetic.images_unit(50_000, cfg.data.output_dim, seed=0)
        n, seed = (20_000, 7) if cfg.dataset == "celeba" else (50_000, 0)
        flat = synthetic.images_int(n, cfg.data.output_dim, seed=seed)
    elif data_dir == "structured":
        # the JAX run's train pool: the first 20,000 of a 24,000-image draw
        flat, _ = synthetic.structured_images_labeled(
            24_000, cfg.data.image_hw, cfg.data.channels, 10, 0)
        flat = flat[:20_000]
        if unit:
            return (flat / 255.0).astype(np.float32)
    else:
        raise NotImplementedError(
            f"--data-dir {data_dir!r}: the port trains on synthetic data "
            "(none, or 'structured'); the dataset loaders wait for the "
            "dataset files")
    return flat.astype(np.uint8)


def run(dataset: str = "cifar10", mode: str = "wali-gp",
        iters: Optional[int] = None, data_dir: Optional[str] = None,
        outdir: str = "result", run_dir: Optional[str] = None,
        seed: int = 0, checkpoint_every: int = 5000, device: str = "cuda",
        **overrides):
    """Train; returns ``(trainer, last metrics)``. ``run_dir`` reuses a
    run directory and resumes from its latest checkpoint."""
    cfg = gan_inference_defaults(dataset, mode, **overrides)
    model = GanInferenceModel(cfg)
    data = resident_data(cfg, data_dir)
    outf = run_dir or make_run_dir(outdir, f"gan_inference_{dataset}",
                                   {"MODE": mode})
    trainer = Trainer(model, data, outf, seed=seed, device=device,
                      checkpoint_every=checkpoint_every)
    return trainer, trainer.train(iters)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="cifar10",
                   choices=["mnist", "cifar10", "svhn", "celeba"])
    p.add_argument("--mode", default="wali-gp", choices=GAN_INFERENCE_MODES)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="omit for random pixels; 'structured' for the "
                        "learnable synthetic family")
    p.add_argument("--outdir", default="result")
    p.add_argument("--run-dir", default=None,
                   help="reuse a run directory and resume from its latest "
                        "checkpoint (default: a new timestamped directory "
                        "under --outdir)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--param-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16: live params at 2 bytes, f32 master "
                        "weights in the optimizer")
    p.add_argument("--moment-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16: Adam moments stored at 2 bytes")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("batch_size", args.batch_size),
                                   ("dim", args.dim),
                                   ("compute_dtype", args.compute_dtype),
                                   ("param_dtype", args.param_dtype),
                                   ("moment_dtype", args.moment_dtype))
                 if v}
    run(args.dataset, args.mode, iters=args.iters, data_dir=args.data_dir,
        outdir=args.outdir, run_dir=args.run_dir, seed=args.seed,
        checkpoint_every=args.checkpoint_every, device=args.device,
        **overrides)


if __name__ == "__main__":
    main()
