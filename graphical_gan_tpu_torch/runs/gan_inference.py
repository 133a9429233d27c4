"""Training entry point for model family 1 (a subset of
``graphical_gan_tpu/runs/gan_inference.py``):

    python -m graphical_gan_tpu_torch.runs.gan_inference \\
        --dataset cifar10 --mode wali-gp --iters N --outdir D

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions then run on the CPU). The data: without ``--data-dir``, 50,000
random-pixel images (the JAX package's synthetic cifar10 train split, as
``bench.py`` uses); ``--data-dir structured``, the learnable structured
family's 20,000-image train pool. Either stays resident on the device as
uint8. Loaders of the real datasets, eval hooks, meshes, preemption and the
other flags of the JAX entry point come in later slices.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.trainer import Trainer, make_run_dir


def resident_data(cfg, data_dir: Optional[str]) -> np.ndarray:
    """The training images as uint8 [N, C*H*W] (flat NCHW order)."""
    if data_dir is None:
        flat = synthetic.images_int(50_000, cfg.data.output_dim, seed=0)
    elif data_dir == "structured":
        # the JAX run's train pool: the first 20,000 of a 24,000-image draw
        flat, _ = synthetic.structured_images_labeled(
            24_000, cfg.data.image_hw, cfg.data.channels, 10, 0)
        flat = flat[:20_000]
    else:
        raise NotImplementedError(
            f"--data-dir {data_dir!r}: the port trains on synthetic data "
            "(none, or 'structured'); the dataset loaders come with the rest "
            "of family 1")
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
    model._check_trainable()
    data = resident_data(cfg, data_dir)
    outf = run_dir or make_run_dir(outdir, f"gan_inference_{dataset}",
                                   {"MODE": mode})
    trainer = Trainer(model, data, outf, seed=seed, device=device,
                      checkpoint_every=checkpoint_every)
    return trainer, trainer.train(iters)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="cifar10", choices=["cifar10", "svhn"])
    p.add_argument("--mode", default="wali-gp")
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
