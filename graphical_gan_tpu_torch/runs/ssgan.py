"""Training entry point for model family 3, SSGAN
(``graphical_gan_tpu/runs/ssgan.py``, the ``ssgan_inference_*`` scripts):

    python -m graphical_gan_tpu_torch.runs.ssgan \\
        --dataset moving_mnist|chairs --mode local_ep|local_epce-z|ali|alice-z

Runs on the card unless ``--device cpu`` is given. ``--pos-mode`` picks the
posterior chain (naive_mean_field, inverse, forward_inverse, gsp),
``--ali-mode`` the ali/alice-z video D (concat_x, concat_z, 3dcnn).

Data: moving-MNIST videos of MNIST digits (``mnist.pkl.gz`` or the idx
files in ``--data-dir``, else the loader's synthetic digits), or with
``--data-dir structured`` of the learnable digit family (20,000 train and
2,000 test 28x28 patterns of ``structured_images_labeled``, seeds 0 and
1), where the reconstruction error measures learning; chairs from
``chairs_64.npy`` in ``--data-dir`` or its synthetic fallback. Three
pipelines (``--data-pipeline``): ``host`` (the default, as in JAX: a fresh
epoch synthesized on the host and copied ahead), ``resident`` (one epoch
frozen on the card) and ``device`` (moving-MNIST only: the digit pool on
the card and the videos synthesized there each iteration,
``data/ondevice_moving_mnist.py``); the last two run in dispatches of
``--chunk-size`` iterations (``train/trainer.py``).

Instruments, as the reference's (``ssgan_inference_moving_mnist.py``): the
parameter count of each player at the start (``:635-641``); the dev costs
every 100 iterations; every ``eval_every`` (5000) iterations the fixed-code
sample grid and GIF (``:569-587``), the fixed dev batch interleaved with
its reconstructions (``:590-602``) with their mean squared error in [0, 1]
(``dev rec l2``), and the disentanglement grid: the inferred motion
regenerated under one fixed global code and label (``:604-618``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from graphical_gan_tpu_torch.core.compile_cache import enable_compile_cache
from graphical_gan_tpu_torch.core.config import (
    ALI_MODES, POS_MODES, SSGAN_MODES, ssgan_defaults)
from graphical_gan_tpu_torch.data import moving_mnist, synthetic
from graphical_gan_tpu_torch.data.common import materialize_epoch
from graphical_gan_tpu_torch.models.ssgan import SSGanModel
from graphical_gan_tpu_torch.report.save_images import save_gifs, save_images
from graphical_gan_tpu_torch.runs.gan_inference import (
    add_failure_flags, add_parallel_flags, check_backend, failure_kwargs,
    maybe_mesh, parallel_kwargs)
from graphical_gan_tpu_torch.train.trainer import Trainer, shared_run_dir

# the eval hook's generator salt (``Trainer.eval_generator``; the dev sweep
# takes 1)
GRID_SALT = 2
PIPELINES = ("host", "resident", "device")


def binarize_labels(y: np.ndarray, n_c: int) -> np.ndarray:
    out = np.zeros((y.shape[0], n_c), np.float32)
    out[np.arange(y.shape[0]), y.astype(int)] = 1.0
    return out


def _structured_pool(cfg, n: int, seed: int):
    """The learnable digit pool: ``n`` 28x28 patterns in [0, 1] of
    ``structured_images_labeled`` (one class per pattern family) and their
    labels. The synthetic MNIST fallback is i.i.d. noise, whose texture no
    8-dim motion chain can carry, so reconstructions there measure only
    what cannot be learnt."""
    n_cls = cfg.n_classes or 10
    d = moving_mnist.DIGIT_SIZE
    flat, y = synthetic.structured_images_labeled(n, (d, d), 1, n_cls, seed)
    return (flat / 255.0).astype(np.float32).reshape(n, d, d), y


def _loaders(cfg, data_dir: Optional[str], stream: str = "native"):
    """(train, dev) epoch-generator factories: moving-MNIST ``{'x': videos,
    'y': one-hot labels}`` dicts (``stream``: the video generator's random
    stream, ``data/moving_mnist.py``), chairs raw pixel videos."""
    if cfg.dataset == "moving_mnist":
        L, b = cfg.seq_len, cfg.batch_size
        if data_dir == "structured":
            tr_x, tr_y = _structured_pool(cfg, 20000, seed=0)
            te_x, te_y = _structured_pool(cfg, 2000, seed=1)
            train = moving_mnist._video_generator(tr_x, tr_y, L, b, 0,
                                                  stream)
            test = moving_mnist._video_generator(te_x, te_y, L, b, 1, stream)
        else:
            train, test = moving_mnist.load_video(L, b, data_dir=data_dir,
                                                  stream=stream)

        def wrap(factory):
            def get_epoch():
                for x, y in factory():
                    yield {"x": x, "y": binarize_labels(y, cfg.n_classes)}
            return get_epoch

        return wrap(train), wrap(test)
    if cfg.dataset == "chairs":
        from graphical_gan_tpu_torch.data import chairs
        return chairs.load(cfg.seq_len, cfg.batch_size, size=cfg.image_hw[0],
                           data_dir=data_dir)
    raise ValueError(cfg.dataset)


def device_pool(cfg, data_dir: Optional[str]):
    """The ``device`` pipeline's resident data: ``{'digits': [N, 28, 28]
    f32, 'labels': [N, n_classes] one-hot}``, the structured pool or
    MNIST's train digits."""
    if data_dir == "structured":
        pool_x, pool_y = _structured_pool(cfg, 20000, seed=0)
    else:
        (pool_x, pool_y), _ = moving_mnist._mnist_pool(None, data_dir)
    d = moving_mnist.DIGIT_SIZE
    return {"digits": np.asarray(pool_x, np.float32).reshape(-1, d, d),
            "labels": binarize_labels(np.asarray(pool_y), cfg.n_classes)}


# -- eval hook ---------------------------------------------------------------

def _vis(cfg, outf: str, x: np.ndarray, iteration: int, num: int,
         name: str) -> None:
    """The montage (rows videos, columns frames) and the animated GIF
    (``:569-576``) of ``num`` videos in [0, 1]."""
    c = cfg.channels
    hgt, wdt = cfg.image_hw
    save_images(x.reshape(-1, c, hgt, wdt),
                os.path.join(outf, f"{name}_{iteration}.png"),
                size=(num, cfg.seq_len))
    save_gifs(x.reshape(num, cfg.seq_len, c, hgt, wdt),
              os.path.join(outf, f"{name}_{iteration}.gif"))


def hook_inputs(cfg, n_dev: int):
    """The hook's fixed f32 inputs, from ``RandomState(0)`` as JAX's:
    (motion codes [n_vis, dl], global codes [n_vis, dlg], one-hot labels
    or None, the disentanglement's one global code tiled [n_dev, dlg], its
    label (class 1) or None); n_vis is the batch size."""
    n_vis = cfg.batch_size
    rng = np.random.RandomState(0)
    pre = rng.normal(size=(n_vis, cfg.dim_latent_l)).astype("float32")
    fixed_g = rng.normal(size=(n_vis, cfg.dim_latent_g)).astype("float32")
    fixed_y = dis_y = None
    if cfg.conditional:
        fixed_y = np.tile(np.eye(cfg.n_classes, dtype="float32"),
                          (max(1, n_vis // cfg.n_classes), 1))[:n_vis]
        dis_y = binarize_labels(np.ones(n_dev), cfg.n_classes)
    dis_g = np.tile(rng.normal(size=(1, cfg.dim_latent_g)),
                    (n_dev, 1)).astype("float32")
    return pre, fixed_g, fixed_y, dis_g, dis_y


def make_eval_hook(model, fixed_dev):
    """The sample, reconstruction and disentanglement grids and GIFs, and
    ``dev rec l2``, of the fixed dev batch."""
    cfg = model.cfg
    dev_x, dev_y = ((fixed_dev["x"], fixed_dev.get("y"))
                    if isinstance(fixed_dev, dict) else (fixed_dev, None))
    dev_x = np.asarray(dev_x, np.float32)
    # the display copy in [0, 1]: chairs batches carry int pixel values
    dev_disp = dev_x / 256.0 if cfg.dataset == "chairs" else dev_x
    pre, fixed_g, fixed_y, dis_g, dis_y = hook_inputs(cfg, dev_x.shape[0])

    @torch.no_grad()
    def hook(trainer, iteration):
        dev = trainer.device
        params = trainer.params

        def on(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(dev)

        def host(t):
            return (t.float().cpu().numpy() + 1.0) / 2.0

        samples = model.sample(params, on(pre), on(fixed_g), on(fixed_y),
                               trainer.eval_generator(GRID_SALT, iteration))
        _vis(cfg, trainer.outf, host(samples), iteration, cfg.batch_size,
             "samples")
        rec = host(model.reconstruct(params, on(dev_x), on(dev_y)))
        trainer.logger.plot("dev rec l2",
                            float(np.mean((dev_disp - rec) ** 2)))
        inter = np.stack([dev_disp, rec], axis=1).reshape(
            -1, cfg.seq_len, cfg.output_dim)
        _vis(cfg, trainer.outf, inter, iteration, 2 * dev_x.shape[0],
             "reconstruction")
        dis = host(model.disentangle(params, on(dev_x), on(dev_y),
                                     on(dis_g), on(dis_y)))
        inter = np.stack([dev_disp, dis], axis=1).reshape(
            -1, cfg.seq_len, cfg.output_dim)
        _vis(cfg, trainer.outf, inter, iteration, 2 * dev_x.shape[0],
             "disentangle")

    return hook


def log_player_param_counts(trainer) -> str:
    """``ssgan_inference_moving_mnist.py:635-641``."""
    counts = [sum(p.numel() for n, p in trainer.params.items()
                  if n.startswith(prefix))
              for prefix in ("Generator", "Extractor", "Discriminator")]
    line = (f"Number of parameters in each player "
            f"[{counts[0]}, {counts[1]}, {counts[2]}, {sum(counts)}]")
    trainer._log(line)
    return line


def run(dataset: str = "moving_mnist", mode: str = "local_ep",
        iters: Optional[int] = None, data_dir: Optional[str] = None,
        outdir: str = "result", run_dir: Optional[str] = None,
        seed: int = 0, checkpoint_every: int = 5000,
        checkpoints_to_keep: int = 3, eval_every: int = 5000,
        data_pipeline: str = "host", device: str = "cuda",
        stream: str = "native", max_rollbacks: int = 0,
        compile_cache: Optional[str] = None,
        checkpoint_backend: str = "npz", n_devices: Optional[int] = None,
        parallel: str = "dp", mesh_shape: Optional[str] = None,
        chunk_size: Optional[int] = None, **overrides):
    """Train; returns ``(trainer, last metrics)``. ``run_dir`` reuses a run
    directory and resumes from its latest checkpoint; ``chunk_size`` is the
    resident and device paths' iterations per dispatch; ``overrides`` are
    config fields (``pos_mode``, ``ali_mode``, ``bn``, ``compute_dtype``,
    ...); SIGTERM, ``max_rollbacks`` and ``compile_cache`` are the failure
    handling of ``runs/gan_inference.py``."""
    check_backend(checkpoint_backend)
    enable_compile_cache(compile_cache)
    mesh = maybe_mesh(n_devices, parallel, mesh_shape, device)
    if data_pipeline not in PIPELINES:
        raise ValueError(f"data_pipeline {data_pipeline!r}: one of "
                         f"{PIPELINES}")
    if data_pipeline == "device" and dataset != "moving_mnist":
        raise ValueError("data_pipeline='device' synthesizes moving-mnist "
                         "only")
    cfg = ssgan_defaults(dataset, mode, **overrides)
    model = SSGanModel(cfg)
    train_gen, dev_gen = _loaders(cfg, data_dir, stream)
    resident, sampler = None, None
    if data_pipeline == "resident":
        resident = materialize_epoch(train_gen)
    elif data_pipeline == "device":
        from graphical_gan_tpu_torch.data.ondevice_moving_mnist import (
            make_video_sampler)
        resident = device_pool(cfg, data_dir)
        sampler = make_video_sampler(cfg.seq_len)
    outf = run_dir or shared_run_dir(mesh, outdir,
                                     f"ssgan_inference_{dataset}",
                                     {"MODE": mode, "ALI_MODE": cfg.ali_mode,
                                      "LEN": cfg.seq_len})
    fixed_dev = next(iter(dev_gen()))
    trainer = Trainer(model, resident, outf, seed=seed, device=device,
                      checkpoint_every=checkpoint_every,
                      eval_hooks={eval_every: make_eval_hook(model,
                                                             fixed_dev)},
                      dev_gen_factory=dev_gen,
                      train_gen_factory=None if resident is not None
                      else train_gen, batch_sampler=sampler,
                      checkpoints_to_keep=checkpoints_to_keep,
                      max_rollbacks=max_rollbacks, mesh=mesh,
                      parallel=parallel,
                      checkpoint_backend=checkpoint_backend,
                      chunk_size=chunk_size)
    # the counts need the state
    if trainer.state is None and not trainer.try_resume():
        trainer.state = trainer.fresh_state()
    trainer.on_rank0(lambda: log_player_param_counts(trainer), full=True)
    trainer.install_preempt_handlers()
    metrics = trainer.train(iters)
    return trainer, metrics


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="moving_mnist",
                   choices=["moving_mnist", "chairs"])
    p.add_argument("--mode", default="local_ep", choices=SSGAN_MODES)
    p.add_argument("--pos-mode", default="naive_mean_field",
                   choices=POS_MODES)
    p.add_argument("--ali-mode", default="concat_x", choices=ALI_MODES)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="the dataset's files (omit for the synthetic "
                        "fallback; 'structured' for the learnable digits)")
    p.add_argument("--data-pipeline", default="host", choices=PIPELINES)
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--outdir", default="result")
    p.add_argument("--run-dir", default=None,
                   help="reuse a run directory and resume from its latest "
                        "checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient accumulation over N microbatches, one "
                        "averaged update (batch_size must divide by N)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--eval-every", type=int, default=5000,
                   help="cadence of the grids, GIFs and dev rec l2")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    add_failure_flags(p)
    add_parallel_flags(p)
    args = p.parse_args(argv)
    overrides = {"pos_mode": args.pos_mode, "ali_mode": args.ali_mode}
    overrides.update({k: v for k, v in (
        ("seq_len", args.seq_len), ("compute_dtype", args.compute_dtype),
        ("accum_steps", args.accum_steps), ("batch_size", args.batch_size),
        ("dim", args.dim)) if v})
    return run(args.dataset, args.mode, iters=args.iters,
               data_dir=args.data_dir, outdir=args.outdir,
               run_dir=args.run_dir, seed=args.seed,
               checkpoint_every=args.checkpoint_every,
               eval_every=args.eval_every, data_pipeline=args.data_pipeline,
               chunk_size=args.chunk_size, device=args.device,
               **failure_kwargs(args),
        **parallel_kwargs(args), **overrides)


if __name__ == "__main__":
    main()
