"""Training entry point for model family 1
(``graphical_gan_tpu/runs/gan_inference.py``):

    python -m graphical_gan_tpu_torch.runs.gan_inference \\
        --dataset mnist|cifar10|svhn|celeba --mode MODE --iters N --outdir D

Every mode of the family trains (``core/config.py: GAN_INFERENCE_MODES``);
with no flags it trains mnist ``ali``, as the JAX entry point does. Runs on
the card unless ``--device cpu`` is given (the kernels' plain versions then
run on the CPU).

Data: with ``--data-dir DIR`` the dataset's files in DIR (mnist
``mnist.pkl.gz`` or the four idx files, the CIFAR-10 pickle batches, SVHN's
``train_32x32.mat`` / ``test_32x32.mat``, ``celebA_64x64.npy``); without
it, or without the files, the loader's synthetic fallback, whose train
split is ``data/pools.py``'s pool; with ``--data-dir structured`` the
learnable structured family. The train split is resident on the device
(one epoch, the partial last batch dropped; integer pixels as uint8), or
host-fed through a prefetcher with ``--data-pipeline host``. Nothing is
downloaded.

Evaluation, at the reference's cadences: a fixed-noise sample grid and an
interleaved data/reconstruction grid every ``sample_every`` iterations
(cifar10 reconstructs its fixed seed-1234 test batch), the dev-set costs
every 100, a TSNE scatter of dev codes every ``tsne_every`` (skipped, with
one log line, where sklearn or matplotlib is missing), and every
``inception_every`` the inception score: on the structured family IS and
FID under a ``MetricClassifier`` trained on its train pool, on cifar10
through ``metrics/inception.py: default_is_classifier`` (skipped, with a
log line, where no Inception weights are on the machine).

Training options: ``--accum-steps N`` (gradient accumulation over N
microbatches, ``train/step.py``); the ``run()`` overrides ``remat=True``,
``fused_gp=True`` and ``decay=True`` (Adam's step size scaled by
``max(0, 1 - t / iters)``, as the JAX entry point passes it; JAX has no
``--decay`` flag either). The alias entry points
``runs/gan_inference_{mnist,cifar10,svhn,face}.py`` fix ``--dataset``
(``face`` is celeba).

Failure handling (``train/trainer.py``): SIGTERM checkpoints the iteration
in flight and exits 0 (resume with ``--run-dir``); ``--max-rollbacks N``
rolls a non-finite training cost back to the latest checkpoint on a new
random stream, up to N times; ``GGAN_ASYNC_CKPT=1`` writes checkpoints on a
worker thread; ``--compile-cache DIR`` builds and loads the CUDA kernels in
DIR (``core/compile_cache.py``); ``--checkpoint-backend npz|orbax``
picks the checkpoint format (``orbax``: ``ckpt_<iter>.orbax`` directories
that each rank writes its part of, ``train/checkpoint_orbax.py``).

``--chunk-size N``: iterations per dispatch of the resident path
(``train/trainer.py``; default: up to the next logging, eval or checkpoint
boundary, at most 100). Every N gives the same bits.

Parallel training (``parallel/``): ``--n-devices N`` with ``--parallel
dp|tp|sp|ep|composed|pp`` and ``--mesh-shape``, parsed as JAX's
``_maybe_mesh`` parses them, one process per rank:

    torchrun --nproc-per-node 2 -m graphical_gan_tpu_torch.runs.gan_inference \
        --dataset cifar10 --mode wali-gp --n-devices 2 --parallel tp

(NCCL on the card, each rank on ``cuda:{LOCAL_RANK}``; gloo with
``--device cpu``). ``--parallel pp`` alone is the 2-stage pipeline (ali,
wali-gp), ``--parallel pp --mesh-shape 4`` the 4-stage cut (cifar10 and
svhn ali), on as many ranks. A mesh of N ranks outside a process group of
N ranks raises with the torchrun line. The GMGAN and SSGAN CLIs do not
offer pp, as in JAX (GMGAN's pipeline is the Trainer's ``parallel="pp"``).
"""

from __future__ import annotations

import argparse
import importlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from graphical_gan_tpu_torch.core.compile_cache import enable_compile_cache
from graphical_gan_tpu_torch.core.config import (
    GAN_INFERENCE_MODES, gan_inference_defaults)
from graphical_gan_tpu_torch.data import pools
from graphical_gan_tpu_torch.data.common import materialize_epoch
from graphical_gan_tpu_torch.models.common import Draws
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.report.save_images import save_images
from graphical_gan_tpu_torch.train.trainer import (
    PARALLEL_CHOICES, Trainer, shared_run_dir)

# the eval generators' salts (``Trainer.eval_generator``; the dev sweep
# takes 1)
GRID_SALT, TSNE_SALT, QUALITY_SALT = 2, 3, 4


def _int_pixels(cfg) -> bool:
    return cfg.data.normalization in ("int_pm1", "dequant", "int256_pm1")


def _structured_pool(cfg, n_classes: int = 10, seed: int = 0,
                     n_train: int = 20000, n_eval: int = 2000):
    """The learnable labeled synthetic family in the dataset's own batch
    convention (mnist float [0, 1], the others raw int pixels): ``(train,
    dev, pools)``, pools the raw ``(train_flat, train_y, eval_flat,
    eval_y)`` that the quality hook trains its classifier on."""
    return pools.structured_loaders(
        cfg.batch_size, cfg.data.image_hw, cfg.data.channels,
        cfg.data.normalization == "unit", n_train, n_eval, n_classes, seed)


def _loaders(cfg, data_dir: Optional[str], seed: int = pools.EPOCH_SEED):
    """(train, dev, structured pools or None): the factories of the
    dataset's loader, their epochs seeded with ``seed``, or of the
    structured family. mnist reads ``<data_dir>/mnist.pkl.gz`` (or the idx
    files beside it)."""
    from graphical_gan_tpu_torch.data import celeba, cifar10, mnist, svhn
    b = cfg.batch_size
    if data_dir == "structured":
        return _structured_pool(cfg)
    if cfg.dataset == "mnist":
        path = os.path.join(data_dir, mnist.FILENAME) if data_dir else None
        train, dev, _test = mnist.load(b, b, path=path, seed=seed)
        return train, dev, None
    loader = {"cifar10": cifar10, "svhn": svhn, "celeba": celeba}
    if cfg.dataset not in loader:
        raise ValueError(cfg.dataset)
    return (*loader[cfg.dataset].load(b, data_dir, seed=seed), None)


def resident_data(cfg, data_dir: Optional[str], train_gen=None
                  ) -> np.ndarray:
    """The training images [N, C*H*W] (flat NCHW order): one epoch of the
    loader's train split (``train_gen``, a fresh factory, else the
    loader's), float32 in [0, 1] for mnist, uint8 pixels otherwise. The
    synthetic fallback (no ``data_dir``) is ``data/pools.py``'s pool, the
    same loader's epoch under its name."""
    if train_gen is None:
        if data_dir is None:
            return pools.SYNTHETIC[cfg.dataset](cfg.batch_size)
        train_gen = _loaders(cfg, data_dir)[0]
    return materialize_epoch(
        train_gen, dtype=np.uint8 if _int_pixels(cfg) else None)


# -- eval hooks ------------------------------------------------------------------

def _to_grid_scale(cfg, flat: np.ndarray) -> np.ndarray:
    """The generator's output range to [0, 1] for the grid writer."""
    if cfg.data.normalization == "unit":
        return flat
    return (flat + 1.0) / 2.0


def _grid_shape(cfg, n):
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    return (n, c, h, w) if c > 1 else (n, h, w)


@torch.no_grad()
def grid_images(model, params, fixed_noise: np.ndarray,
                fixed_dev_batch: Optional[np.ndarray] = None,
                generator=None, draws: Optional[Dict] = None):
    """(the sample grid's images, the reconstruction grid's or None) as
    float arrays in [0, 1], before the grid writer quantizes them
    (``gan_inference_mnist.py:366-396``): G of the fixed f32 noise, and the
    dev batch's normalized images interleaved row by row with their
    reconstructions. ``draws`` optionally maps "rec" / "norm" to the
    reconstruction's and the data image's draws (celeba's dequantization,
    a stochastic posterior's eps); otherwise they come from
    ``generator``."""
    cfg = model.cfg
    dev = next(iter(params.values())).device
    draws = draws or {}
    samples = model.sample(params, torch.from_numpy(fixed_noise).to(dev))
    img = _to_grid_scale(cfg, samples.float().cpu().numpy())
    img = img.reshape(_grid_shape(cfg, fixed_noise.shape[0]))
    if fixed_dev_batch is None:
        return img, None
    raw = torch.from_numpy(np.ascontiguousarray(fixed_dev_batch)).to(dev)
    rec = model.reconstruct(params, raw, generator, draws.get("rec"))
    data_img = model.normalize(raw, Draws(draws.get("norm"), generator))
    rec = _to_grid_scale(cfg, rec.float().cpu().numpy())
    data_img = _to_grid_scale(cfg, data_img.float().cpu().numpy())
    inter = np.stack([data_img, rec], axis=1).reshape(-1, data_img.shape[-1])
    return img, inter.reshape(_grid_shape(cfg, 2 * raw.shape[0]))


def make_eval_hooks(model, fixed_dev_batch, draws: Optional[Dict] = None):
    """Sample and reconstruction grids at the reference cadence: the fixed
    noise is ``RandomState(0)``'s, as in the JAX hook."""
    cfg = model.cfg
    fixed_noise = np.random.RandomState(0).normal(
        size=(cfg.n_vis, cfg.dim_latent)).astype("float32")

    def hook(trainer, iteration):
        samples, rec = grid_images(
            model, trainer.params, fixed_noise, fixed_dev_batch,
            trainer.eval_generator(GRID_SALT, iteration), draws)
        stem = os.path.join(trainer.outf, f"{cfg.mode}_{cfg.dataset}_")
        save_images(samples, f"{stem}samples_{iteration}.png")
        if rec is not None:
            save_images(rec, f"{stem}reconstruction_{iteration}.png")

    return hook


def _missing_module(names) -> Optional[str]:
    """The first of ``names`` that does not import, as 'name: error'."""
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as e:
            return f"{name}: {e}"
    return None


def make_tsne_hook(model, dev_gen):
    """The latent manifold scatter at the 50k cadence
    (``gan_inference_mnist.py:473-480``): TSNE of the dev set's codes,
    colored by label. Where sklearn or matplotlib is missing it logs
    ``tsne skipped: <reason>`` once and plots nothing."""
    skipped = []

    @torch.no_grad()
    def hook(trainer, iteration):
        missing = _missing_module(("sklearn.manifold", "matplotlib"))
        if missing:
            if not skipped:
                trainer._log(f"tsne skipped: {missing}")
                skipped.append(iteration)
            return
        from graphical_gan_tpu_torch.report.visualization import (
            scatter, tsne_2d)
        cfg = model.cfg
        gen = trainer.eval_generator(TSNE_SALT, iteration)
        zs, ys = [], []
        for batch in dev_gen():
            if not isinstance(batch, tuple):
                return  # an unlabeled dataset (celeba): no class colors
            xb, yb = batch
            z = model.encode(trainer.params,
                             torch.from_numpy(xb).to(trainer.device), gen)
            zs.append(z.float().cpu().numpy())
            ys.append(yb)
        z2 = tsne_2d(np.vstack(zs))
        scatter(z2, np.hstack(ys), trainer.outf,
                f"{cfg.mode}_{cfg.dataset}_manifold_{iteration}.png")

    return hook


@torch.no_grad()
def sample_images(model, params, n: int, batch: int, generator,
                  sample=None) -> list:
    """``n`` generator samples as HWC arrays in [0, 255] (float32), in
    batches of ``batch``, each ``sample(batch)`` (by default G of f32 codes
    drawn by ``generator``, so the generator runs in f32, as the JAX hooks'
    f32 codes make it run): sigmoid outputs scale by 255, tanh outputs map
    [-1, 1] to [0, 255]."""
    cfg = model.cfg
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    dev = next(iter(params.values())).device
    if sample is None:
        def sample(b):
            return model.sample(params, torch.randn(
                (b, cfg.dim_latent), generator=generator, device=dev))
    out = []
    for _ in range(-(-n // batch)):
        flat = sample(batch).float()
        x = flat * 255.0 if cfg.data.normalization == "unit" \
            else (flat + 1.0) * (255.0 / 2)
        x = x.clamp(0, 255).reshape(-1, c, h, w).permute(0, 2, 3, 1)
        out.append(x.cpu())
    return list(torch.cat(out)[:n].numpy())


def make_inception_hook(model, n_samples: int = 50000,
                        sample_batch: int = 100, classifier=None):
    """The inception score at the 10k cadence (``gan_inference_cifar10.py:
    381-391, 484-487``): ``n_samples`` generated in batches of 100, [-1, 1]
    -> [0, 255] HWC, the 10-split exp-mean-KL. Without a classifier given,
    ``default_is_classifier`` builds one on the trainer's device; where
    the machine has none (it raises) the hook logs a skip."""
    from graphical_gan_tpu_torch.metrics.inception import (
        default_is_classifier, get_inception_score)

    def hook(trainer, iteration):
        nonlocal classifier
        if classifier is None:
            try:
                classifier = default_is_classifier(trainer.device)
            except (ImportError, OSError, RuntimeError,
                    NotImplementedError) as e:
                trainer.logger.plot("inception score skipped", 0.0)
                print(f"inception score skipped (no classifier): {e}")
                return
        gen = trainer.eval_generator(QUALITY_SALT, iteration)
        imgs = [x.astype(np.int32) for x in sample_images(
            model, trainer.params, n_samples, sample_batch, gen)]
        mean, std = get_inception_score(imgs, classifier)
        trainer.logger.plot("inception score", mean)
        trainer.logger.plot("inception score std", std)

    return hook


def make_structured_quality_hook(model, pools_, n_score: int = 10000,
                                 sample_batch: int = 100,
                                 clf_steps: int = 2000, clf_dim: int = 32,
                                 n_classes: int = 10, seed: int = 0):
    """IS and FID for ``--data-dir structured`` runs at the inception
    cadence: a ``MetricClassifier`` trained once on the structured train
    pool (at the hook's first firing) scores ``n_score`` fresh generator
    samples at every firing: IS by the 10-split exp-mean-KL
    (``tflib/inception_score.py:47-53``), FID against the train pool's
    feature Gaussian. The classifier's held-out accuracy is logged once,
    the instrument's own check."""
    cfg = model.cfg
    h, w = cfg.data.image_hw
    c = cfg.data.channels
    state = {}

    def _ensure_instrument(trainer):
        if "prob_fn" in state:
            return
        from graphical_gan_tpu_torch.metrics.classifier import (
            MetricClassifier)
        from graphical_gan_tpu_torch.metrics.fid import gaussian_stats
        train_flat, train_y, eval_flat, eval_y = pools_
        clf = MetricClassifier(image_hw=(h, w), channels=c,
                               n_classes=n_classes, dim=clf_dim,
                               device=trainer.device)
        clf_params = clf.fit(train_flat, train_y, steps=clf_steps, seed=seed)
        acc = clf.accuracy(clf_params, eval_flat, eval_y)
        trainer.logger.plot("metric classifier heldout acc", float(acc))
        state["feature_fn"] = clf.as_feature_fn(clf_params)
        state["prob_fn"] = clf.as_prob_fn(clf_params)
        real = np.asarray(train_flat[:n_score]).reshape(-1, c, h, w)
        real = real.transpose(0, 2, 3, 1).astype(np.float64)
        state["real_mu"], state["real_sigma"] = gaussian_stats(
            state["feature_fn"](real))

    def hook(trainer, iteration):
        from graphical_gan_tpu_torch.metrics.fid import (
            frechet_distance, gaussian_stats)
        from graphical_gan_tpu_torch.metrics.inception import (
            get_inception_score)
        _ensure_instrument(trainer)
        imgs = sample_images(model, trainer.params, n_score, sample_batch,
                         trainer.eval_generator(QUALITY_SALT, iteration))
        mean, std = get_inception_score(imgs, state["prob_fn"])
        mu, sigma = gaussian_stats(state["feature_fn"](np.asarray(imgs)))
        fid = frechet_distance(state["real_mu"], state["real_sigma"],
                               mu, sigma)
        trainer.logger.plot("inception score", float(mean))
        trainer.logger.plot("inception score std", float(std))
        trainer.logger.plot("fid", float(fid))

    return hook


def add_hook(hooks: Dict, every: int, fn) -> None:
    """Add ``fn`` at cadence ``every``, after any hook already there."""
    if every in hooks:
        prev = hooks[every]
        hooks[every] = lambda tr, it: (prev(tr, it), fn(tr, it))
    else:
        hooks[every] = fn


def add_failure_flags(p: argparse.ArgumentParser) -> None:
    """The training CLIs' flags of the failure handling (JAX
    ``runs/gan_inference.py:469-483``)."""
    p.add_argument("--max-rollbacks", type=int, default=0,
                   help="divergence guard: on a non-finite training cost, "
                        "roll back to the latest checkpoint and retry on a "
                        "new random stream, up to N times (0 disables)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build and load the CUDA kernel library in DIR, so "
                        "a restart or another checkout pointing there runs "
                        "no nvcc (also GGAN_COMPILE_CACHE; the flag wins)")
    p.add_argument("--checkpoint-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="checkpoint format: npz (atomic single file, "
                        "written by rank 0) or orbax (a directory each "
                        "rank writes its part of, torch.distributed."
                        "checkpoint)")


def failure_kwargs(args) -> Dict:
    return {"max_rollbacks": args.max_rollbacks,
            "compile_cache": args.compile_cache,
            "checkpoint_backend": args.checkpoint_backend}


def check_backend(checkpoint_backend: str) -> None:
    if checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint_backend "
                         f"{checkpoint_backend!r} (npz|orbax)")


def add_parallel_flags(p: argparse.ArgumentParser, pp: bool = False
                       ) -> None:
    """The training CLIs' mesh flags (JAX ``runs/gan_inference.py:
    452-466``); ``pp`` offers the pipeline (family 1's CLI only, as in
    JAX)."""
    p.add_argument("--n-devices", type=int, default=None,
                   help="train over N ranks, one process each: launch "
                        "with `torchrun --nproc-per-node N -m ...` "
                        "(params replicated under dp)")
    choices = [c for c in PARALLEL_CHOICES if pp or c != "pp"]
    p.add_argument("--parallel", default="dp", choices=choices,
                   help="strategy over the mesh: dp (batch), tp (channel "
                        "sharding, data x model), sp (video frames, data x "
                        "seq), ep (mixture components, data x expert), "
                        "composed (named --mesh-shape)"
                        + ("; pp (pipeline stages: 2, or --mesh-shape 4)"
                           if pp else ""))
    p.add_argument("--mesh-shape", default=None,
                   help="mesh dims: 'd,m' for tp/sp/ep, named for "
                        "composed, e.g. data=2,model=2"
                        + (", the stage count for pp" if pp else ""))


def parallel_kwargs(args) -> Dict:
    return {"n_devices": args.n_devices, "parallel": args.parallel,
            "mesh_shape": args.mesh_shape}


def maybe_mesh(n_devices: Optional[int], parallel: str = "dp",
               mesh_shape: Optional[str] = None, device: str = "cuda"):
    """This rank's mesh for the strategy, or None for one device (JAX
    ``_maybe_mesh``, ``runs/gan_inference.py:80-122``): ``mesh_shape``
    "d,m" (data x model / seq / expert) or named ("data=2,seq=2,model=2");
    defaults dp = 1-D over ``n_devices``, tp/sp/ep = 2 x (n_devices / 2),
    pp = 2 stages (``--parallel pp`` alone builds it; ``mesh_shape`` "4"
    the 4-stage cut). A mesh of N ranks outside a process group of N ranks
    raises with the torchrun line (``parallel/mesh.py: make_mesh``)."""
    if mesh_shape is None and (not n_devices or n_devices <= 1) \
            and parallel != "pp":
        return None
    from graphical_gan_tpu_torch.parallel.mesh import make_mesh
    if parallel == "pp":
        return make_mesh(shape=(int(mesh_shape) if mesh_shape else 2,),
                         axis_names=("stage",), device=device)
    if parallel == "dp":
        return make_mesh(n_devices, device=device)
    if mesh_shape and "=" in mesh_shape:
        pairs = [kv.split("=") for kv in mesh_shape.split(",")]
        axes = tuple(kk for kk, _ in pairs)
        dims = tuple(int(v) for _, v in pairs)
    else:
        axes = {"tp": ("data", "model"), "sp": ("data", "seq"),
                "ep": ("data", "expert")}.get(parallel)
        if axes is None:
            raise ValueError(
                f"--parallel {parallel} needs a named --mesh-shape "
                f"(e.g. data=2,seq=2,model=2)")
        if mesh_shape:
            dims = tuple(int(v) for v in mesh_shape.split(","))
        else:
            import torch.distributed as dist
            world = n_devices or (dist.get_world_size()
                                  if dist.is_initialized() else 1)
            dims = (2, world // 2)
    return make_mesh(shape=dims, axis_names=axes, device=device)


def run(dataset: str = "mnist", mode: str = "ali",
        iters: Optional[int] = None, data_dir: Optional[str] = None,
        outdir: str = "result", run_dir: Optional[str] = None,
        seed: int = 0, checkpoint_every: int = 5000,
        checkpoints_to_keep: int = 3,
        sample_every: Optional[int] = None, tsne_every: int = 50000,
        inception_every: int = 10000, data_pipeline: Optional[str] = None,
        device: str = "cuda", max_rollbacks: int = 0,
        compile_cache: Optional[str] = None,
        checkpoint_backend: str = "npz", n_devices: Optional[int] = None,
        parallel: str = "dp", mesh_shape: Optional[str] = None,
        chunk_size: Optional[int] = None, **overrides):
    """Train; returns ``(trainer, last metrics)``. ``run_dir`` reuses a
    run directory and resumes from its latest checkpoint; ``chunk_size``
    is the resident path's iterations per dispatch; ``n_devices``,
    ``parallel`` and ``mesh_shape`` train this rank of a mesh
    (:func:`maybe_mesh`)."""
    check_backend(checkpoint_backend)
    enable_compile_cache(compile_cache)
    mesh = maybe_mesh(n_devices, parallel, mesh_shape, device)
    cfg = gan_inference_defaults(dataset, mode, **overrides)
    model = GanInferenceModel(cfg)
    train_gen, dev_gen, structured_pools = _loaders(cfg, data_dir)
    data_pipeline = data_pipeline or "resident"
    if data_pipeline not in ("resident", "host"):
        raise ValueError(f"data_pipeline {data_pipeline!r}: resident or host")
    resident = resident_data(cfg, data_dir, train_gen) \
        if data_pipeline == "resident" else None

    outf = run_dir or shared_run_dir(mesh, outdir,
                                     f"gan_inference_{dataset}",
                                     {"MODE": mode})
    if dataset == "cifar10" and data_dir != "structured":
        # the fixed seed-1234 test-set reconstruction batch
        # (tflib/cifar10.py:14-19; gan_inference_cifar10.py:400-404)
        from graphical_gan_tpu_torch.data.cifar10 import (
            get_reconstruction_data)
        fixed_dev = get_reconstruction_data(cfg.batch_size, data_dir)
    else:
        fixed_dev = next(iter(dev_gen()))
        if isinstance(fixed_dev, tuple):
            fixed_dev = fixed_dev[0]

    sample_every = sample_every or (1000 if dataset == "celeba" else 5000)
    hooks: Dict = {}
    add_hook(hooks, sample_every, make_eval_hooks(model, fixed_dev))
    if tsne_every:
        add_hook(hooks, tsne_every, make_tsne_hook(model, dev_gen))
    if structured_pools is not None and inception_every:
        add_hook(hooks, inception_every,
                 make_structured_quality_hook(model, structured_pools,
                                              seed=seed))
    elif dataset == "cifar10" and inception_every:
        add_hook(hooks, inception_every, make_inception_hook(model))
    trainer = Trainer(model, resident, outf, seed=seed, device=device,
                      checkpoint_every=checkpoint_every, eval_hooks=hooks,
                      dev_gen_factory=dev_gen,
                      train_gen_factory=None if resident is not None
                      else train_gen, lr_scale=decay_scale(cfg),
                      checkpoints_to_keep=checkpoints_to_keep,
                      max_rollbacks=max_rollbacks, mesh=mesh,
                      parallel=parallel,
                      checkpoint_backend=checkpoint_backend,
                      chunk_size=chunk_size)
    # SIGTERM checkpoints and stops cleanly (no-op off the main thread)
    trainer.install_preempt_handlers()
    return trainer, trainer.train(iters)


def decay_scale(cfg):
    """Adam's ``lr_scale`` for ``cfg.decay``: ``max(0, 1 - t / iters)`` at
    the optimizer's step t (JAX ``runs/gan_inference.py:400-401``), else
    None."""
    if not cfg.decay:
        return None
    return lambda t: max(0.0, 1.0 - t / cfg.iters)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "svhn", "celeba"])
    p.add_argument("--mode", default="ali", choices=GAN_INFERENCE_MODES)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="the dataset's files (omit for the synthetic "
                        "fallback; 'structured' for the learnable "
                        "synthetic family)")
    p.add_argument("--data-pipeline", default=None,
                   choices=["resident", "host"],
                   help="resident (default): the train split on the device; "
                        "host: per-iteration host batches, prefetched")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="iterations fused per device dispatch in resident "
                        "mode (default: auto — fuse up to the next "
                        "logging/eval event boundary)")
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
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient accumulation: each update's batch split "
                        "into N microbatches with one averaged optimizer "
                        "update (batch_size must divide by N)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    add_failure_flags(p)
    add_parallel_flags(p, pp=True)
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("batch_size", args.batch_size),
                                   ("dim", args.dim),
                                   ("compute_dtype", args.compute_dtype),
                                   ("param_dtype", args.param_dtype),
                                   ("moment_dtype", args.moment_dtype),
                                   ("accum_steps", args.accum_steps))
                 if v}
    run(args.dataset, args.mode, iters=args.iters, data_dir=args.data_dir,
        outdir=args.outdir, run_dir=args.run_dir, seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        data_pipeline=args.data_pipeline, chunk_size=args.chunk_size,
        device=args.device, **failure_kwargs(args), **parallel_kwargs(args),
        **overrides)


if __name__ == "__main__":
    main()
