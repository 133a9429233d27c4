"""Training entry point for model family 1 (a subset of
``graphical_gan_tpu/runs/gan_inference.py``):

    python -m graphical_gan_tpu_torch.runs.gan_inference \\
        --dataset mnist|cifar10|svhn|celeba --mode MODE --iters N --outdir D

Every mode of the family trains (``core/config.py: GAN_INFERENCE_MODES``);
with no flags it trains mnist ``ali``, as the JAX entry point does. Runs on
the card unless ``--device cpu`` is given (the kernels' plain versions then
run on the CPU). The data are resident on the device: without
``--data-dir``, the train split of the JAX loader's synthetic fallback
(mnist 50,000 float32 images in [0, 1], cifar10 50,000 and svhn 73,257
random-pixel images, celeba 15,000 of 20,000 after its dev split), and
with ``--data-dir structured`` the learnable structured family's
20,000-image train pool, each through one epoch with the partial last
batch dropped (``data/pools.py``). Loaders of the real datasets (the
dataset files are not in the repository), eval hooks, meshes, preemption
and the other flags of the JAX entry point come in later slices.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from graphical_gan_tpu_torch.core.config import (
    GAN_INFERENCE_MODES, gan_inference_defaults)
from graphical_gan_tpu_torch.data import pools
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train.trainer import Trainer, make_run_dir


def resident_data(cfg, data_dir: Optional[str]) -> np.ndarray:
    """The training images [N, C*H*W] (flat NCHW order): float32 in [0, 1]
    for mnist (``normalization == 'unit'``), uint8 pixels otherwise."""
    if data_dir is None:
        return pools.SYNTHETIC[cfg.dataset](cfg.batch_size)
    if data_dir == "structured":
        return pools.structured(cfg.batch_size, cfg.data.image_hw,
                                cfg.data.channels,
                                cfg.data.normalization == "unit")
    raise NotImplementedError(
        f"--data-dir {data_dir!r}: the port trains on synthetic data "
        "(none, or 'structured'); the dataset loaders wait for the "
        "dataset files")


def run(dataset: str = "mnist", mode: str = "ali",
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
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "svhn", "celeba"])
    p.add_argument("--mode", default="ali", choices=GAN_INFERENCE_MODES)
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
