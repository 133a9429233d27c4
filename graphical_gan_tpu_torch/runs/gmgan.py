"""Training entry point for model family 2, GMGAN
(``graphical_gan_tpu/runs/gmgan.py``, the ``gmgan_inference_*`` scripts):

    python -m graphical_gan_tpu_torch.runs.gmgan \\
        --dataset mnist|cifar10|svhn|celeba --mode MODE --mode-k MODE_K

Modes ali, local_ep (the default), alice, local_epce and vegan, each under
CONCRETE (the default), STRAIGHT_THROUGHT_CONCRETE, STRAIGHT_THROUGHT or
REINFORCE. Runs on the card unless ``--device cpu`` is given.

Data as in ``runs/gan_inference.py``: the dataset's files in ``--data-dir``
or the loader's synthetic fallback, resident on the device (dispatches of
``--chunk-size`` iterations) or host-fed (``--data-pipeline host``);
``--data-dir structured`` trains on the
learnable labeled family (20,000 train, 2,000 dev and 2,000 test rows of
``structured_images_labeled(24000, ..., seed 0)``, each split's epochs
seeded 1, 2, 3), where the clustering accuracy is a real number.

Evaluation every ``eval_every`` iterations (5000; ``--eval-every``), as the
reference's (``gmgan_inference_mnist.py``): a per-component sample grid
(rows are fixed noise, columns the components, ``:405-419``), the fixed dev
batch interleaved with its reconstructions (``:428-442``), the clustering
accuracy of q(k|x) over the test split (``testing accuracy``,
``:513-531``), and on cifar10 the inception score of 50,000 samples of the
mixture prior (skipped, with a log line, where no Inception weights are on
the machine); the dev costs every 100 iterations; after the last
iteration the 4-way TSNE scatters (``:534-551``; skipped, with one log
line, where sklearn or matplotlib is missing).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core.compile_cache import enable_compile_cache
from graphical_gan_tpu_torch.core.config import (
    GMGAN_MODES, MODE_KS, gmgan_defaults)
from graphical_gan_tpu_torch.data import pools, synthetic
from graphical_gan_tpu_torch.data.common import generator_factory
from graphical_gan_tpu_torch.metrics.clustering import clustering_accuracy
from graphical_gan_tpu_torch.models.common import Draws
from graphical_gan_tpu_torch.models.gmgan import GMGanModel
from graphical_gan_tpu_torch.report.save_images import save_images
from graphical_gan_tpu_torch.runs.gan_inference import (
    _grid_shape, _missing_module, _to_grid_scale, add_failure_flags,
    add_parallel_flags, check_backend, failure_kwargs, maybe_mesh,
    parallel_kwargs, resident_data, sample_images)
from graphical_gan_tpu_torch.train.trainer import Trainer, shared_run_dir

# the eval generators' salts (``Trainer.eval_generator``; the dev sweep
# takes 1)
GRID_SALT, TSNE_SALT, QUALITY_SALT = 2, 3, 4


def _structured_loaders(cfg, n_classes: int = 10, seed: int = 0,
                        n_train: int = 20000, n_eval: int = 2000):
    """The learnable labeled family in the dataset's batch convention
    (mnist float [0, 1], the others raw int pixels): the (train, dev,
    test) factories of ``(x, y)`` batches, epochs seeded 1, 2, 3."""
    h, w = cfg.data.image_hw
    n = n_train + 2 * n_eval
    flat, y = synthetic.structured_images_labeled(
        n, (h, w), cfg.data.channels, n_classes, seed)
    if cfg.data.normalization == "unit":
        flat = (flat / 255.0).astype(np.float32)
    sl = [slice(0, n_train), slice(n_train, n_train + n_eval),
          slice(n_train + n_eval, n)]
    return tuple(generator_factory(cfg.batch_size, flat[s], y[s],
                                   seed=i + 1) for i, s in enumerate(sl))


def _loaders(cfg, data_dir: Optional[str], seed: int = pools.EPOCH_SEED):
    """(train, dev, test or None) factories: the structured family's, or
    the dataset loader's, their epochs seeded with ``seed`` (cifar10 and
    svhn test on their test split, which is also their dev split; celeba
    has no labels, so no test split)."""
    from graphical_gan_tpu_torch.data import celeba, cifar10, mnist, svhn
    b = cfg.batch_size
    if data_dir == "structured":
        return _structured_loaders(cfg)
    if cfg.dataset == "mnist":
        path = os.path.join(data_dir, mnist.FILENAME) if data_dir else None
        return mnist.load(b, b, path=path, seed=seed)
    if cfg.dataset in ("cifar10", "svhn"):
        loader = cifar10 if cfg.dataset == "cifar10" else svhn
        train, test = loader.load(b, data_dir, seed=seed)
        return train, test, test
    if cfg.dataset == "celeba":
        train, dev = celeba.load(b, data_dir, seed=seed)
        return train, dev, None
    raise ValueError(cfg.dataset)


# -- eval hooks ---------------------------------------------------------------

def grid_inputs(cfg):
    """The per-component grid's (one-hot components, f32 noise): n_vis
    rounded down to a multiple of n_coms, the noise ``RandomState(0)``'s,
    each row of the grid one noise vector across every component
    (``gmgan_inference_mnist.py:405-419``)."""
    n_vis = cfg.n_vis - (cfg.n_vis % cfg.n_coms) or cfg.n_coms
    noise = np.random.RandomState(0).normal(
        size=(n_vis, cfg.dim_latent)).astype("float32")
    k = np.tile(np.eye(cfg.n_coms, dtype=np.float32),
                (n_vis // cfg.n_coms, 1))
    return k, noise


def make_sample_hook(model):
    """The per-component sample grid, ``<it>_samples_<mode>.png``."""
    cfg = model.cfg
    k, noise = grid_inputs(cfg)

    @torch.no_grad()
    def hook(trainer, iteration):
        dev = trainer.device
        x = model.sample(trainer.params, torch.from_numpy(k).to(dev),
                         torch.from_numpy(noise).to(dev))
        img = _to_grid_scale(cfg, x.float().cpu().numpy())
        save_images(img.reshape(_grid_shape(cfg, len(k))),
                    os.path.join(trainer.outf,
                                 f"{iteration}_samples_{cfg.mode}.png"),
                    size=[len(k) // cfg.n_coms, cfg.n_coms])

    return hook


def make_recon_hook(model, fixed_dev_batch):
    """The dev batch interleaved row by row with its reconstructions,
    ``<it>_reconstruction_<mode>.png``."""
    cfg = model.cfg

    @torch.no_grad()
    def hook(trainer, iteration):
        gen = trainer.eval_generator(GRID_SALT, iteration)
        raw = torch.from_numpy(np.ascontiguousarray(fixed_dev_batch)).to(
            trainer.device)
        rec = model.reconstruct(trainer.params, raw, gen)
        dat = model.normalize(raw, Draws(None, gen))
        rec = _to_grid_scale(cfg, rec.float().cpu().numpy())
        dat = _to_grid_scale(cfg, dat.float().cpu().numpy())
        inter = np.stack([dat, rec], axis=1).reshape(-1, dat.shape[-1])
        save_images(inter.reshape(_grid_shape(cfg, 2 * raw.shape[0])),
                    os.path.join(trainer.outf,
                                 f"{iteration}_reconstruction_{cfg.mode}.png"))

    return hook


def make_accuracy_hook(model, test_gen_factory):
    """Clustering accuracy over the test split, ``testing accuracy``
    (``:513-531``)."""
    @torch.no_grad()
    def hook(trainer, iteration):
        gen = trainer.eval_generator(QUALITY_SALT, iteration)
        probs, ys = [], []
        for xb, yb in test_gen_factory():
            raw = torch.from_numpy(np.ascontiguousarray(xb))
            probs.append(model.cluster_probs(
                trainer.params, raw.to(trainer.device), gen))
            ys.append(yb)
        # one fetch of the stacked posteriors
        probs = torch.cat(probs).float().cpu().numpy()
        trainer.logger.plot("testing accuracy",
                            clustering_accuracy(probs, np.hstack(ys)))

    return hook


@torch.no_grad()
def tsne_visualizations(trainer, model, dev_gen_factory, iteration):
    """The final 4-way TSNE scatters (``:534-551``): inferred codes by
    class, prior samples by component, data by inferred cluster and by
    class. Where sklearn or matplotlib is missing it logs ``tsne skipped:
    <reason>`` and plots nothing."""
    missing = _missing_module(("sklearn.manifold", "matplotlib"))
    if missing:
        trainer._log(f"tsne skipped: {missing}")
        return
    from graphical_gan_tpu_torch.report.visualization import scatter, tsne_2d
    cfg, dev = model.cfg, trainer.device
    gen = trainer.eval_generator(TSNE_SALT, iteration)
    z, qk, pz, pk, ys, xs = [], [], [], [], [], []
    for xb, yb in dev_gen_factory():
        raw = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
        q_z = model.encode(trainer.params, raw, gen)
        logits = model.component_logits(trainer.params, q_z)
        q_k = model.posterior_sample(logits, Draws(None, gen), "gumbel_q")
        b = raw.shape[0]
        idx = torch.randint(0, cfg.n_coms, (b,), generator=gen, device=dev)
        eps = torch.randn((b, cfg.dim_latent), generator=gen, device=dev)
        p_z = model.hyper_generator(
            trainer.params, F.one_hot(idx, cfg.n_coms), eps)
        z.append(q_z.float().cpu().numpy())
        qk.append(q_k.argmax(dim=1).cpu().numpy())
        pz.append(p_z.cpu().numpy())
        pk.append(idx.cpu().numpy())
        ys.append(yb)
        xs.append(np.asarray(xb, np.float32))
    stem = f"{iteration}_{{}}_{cfg.mode}.png"
    scatter(tsne_2d(np.vstack(z)), np.hstack(ys), trainer.outf,
            stem.format("manifold"))
    scatter(tsne_2d(np.vstack(pz)), np.hstack(pk), trainer.outf,
            stem.format("prior"))
    x2 = tsne_2d(np.vstack(xs))
    scatter(x2, np.hstack(qk), trainer.outf, stem.format("cluster"))
    scatter(x2, np.hstack(ys), trainer.outf, stem.format("dev_data_vis"))


@torch.no_grad()
def mixture_samples(model, params, n: int, batch: int, generator) -> list:
    """``n`` samples of the mixture prior as HWC arrays in [0, 255]
    (float32), in batches of ``batch``: a uniform component and N(0, I)
    eps per row, drawn by ``generator``."""
    cfg = model.cfg
    dev = next(iter(params.values())).device

    def sample(b):
        idx = torch.randint(0, cfg.n_coms, (b,), generator=generator,
                            device=dev)
        eps = torch.randn((b, cfg.dim_latent), generator=generator,
                          device=dev)
        return model.sample(params, F.one_hot(idx, cfg.n_coms), eps)

    return sample_images(model, params, n, batch, generator, sample)


def make_gmgan_inception_hook(model, n_samples: int = 50000,
                              sample_batch: int = 100, classifier=None):
    """The inception score of ``n_samples`` samples of the mixture prior
    (``gmgan_inference_cifar10.py:429-442``); where the machine has no
    Inception weights the hook logs a skip."""
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
        imgs = [x.astype(np.int32) for x in mixture_samples(
            model, trainer.params, n_samples, sample_batch,
            trainer.eval_generator(QUALITY_SALT, iteration))]
        mean, std = get_inception_score(imgs, classifier)
        trainer.logger.plot("inception score", mean)
        trainer.logger.plot("inception score std", std)

    return hook


def run(dataset: str = "mnist", mode: str = "local_ep",
        iters: Optional[int] = None, data_dir: Optional[str] = None,
        outdir: str = "result", run_dir: Optional[str] = None,
        seed: int = 0, checkpoint_every: int = 5000,
        checkpoints_to_keep: int = 3, eval_every: int = 5000,
        data_pipeline: Optional[str] = None, device: str = "cuda",
        max_rollbacks: int = 0, compile_cache: Optional[str] = None,
        checkpoint_backend: str = "npz", n_devices: Optional[int] = None,
        parallel: str = "dp", mesh_shape: Optional[str] = None,
        chunk_size: Optional[int] = None, **overrides):
    """Train; returns ``(trainer, last metrics)``. ``run_dir`` reuses a
    run directory and resumes from its latest checkpoint; ``chunk_size``
    is the resident path's iterations per dispatch; SIGTERM,
    ``max_rollbacks`` and ``compile_cache`` are the failure handling of
    ``runs/gan_inference.py``."""
    check_backend(checkpoint_backend)
    enable_compile_cache(compile_cache)
    mesh = maybe_mesh(n_devices, parallel, mesh_shape, device)
    cfg = gmgan_defaults(dataset, mode, **overrides)
    model = GMGanModel(cfg)
    train_gen, dev_gen, test_gen = _loaders(cfg, data_dir)
    data_pipeline = data_pipeline or "resident"
    if data_pipeline not in ("resident", "host"):
        raise ValueError(f"data_pipeline {data_pipeline!r}: resident or host")
    resident = resident_data(cfg, data_dir, train_gen) \
        if data_pipeline == "resident" else None
    outf = run_dir or shared_run_dir(mesh, outdir,
                                     f"gmgan_inference_{dataset}",
                                     {"MODE": mode, "N_COMS": cfg.n_coms})
    fixed_dev = next(iter(dev_gen()))
    if isinstance(fixed_dev, tuple):
        fixed_dev = fixed_dev[0]
    hooks = [make_sample_hook(model), make_recon_hook(model, fixed_dev)]
    if test_gen is not None:
        hooks.append(make_accuracy_hook(model, test_gen))
    if dataset == "cifar10":
        hooks.append(make_gmgan_inception_hook(model))

    def combined(trainer, iteration):
        for hook in hooks:
            hook(trainer, iteration)

    trainer = Trainer(model, resident, outf, seed=seed, device=device,
                      checkpoint_every=checkpoint_every,
                      eval_hooks={eval_every: combined},
                      dev_gen_factory=dev_gen,
                      train_gen_factory=None if resident is not None
                      else train_gen,
                      checkpoints_to_keep=checkpoints_to_keep,
                      max_rollbacks=max_rollbacks, mesh=mesh,
                      parallel=parallel,
                      checkpoint_backend=checkpoint_backend,
                      chunk_size=chunk_size)
    trainer.install_preempt_handlers()
    metrics = trainer.train(iters)
    if dataset != "celeba":
        final = (iters if iters is not None else cfg.iters) - 1
        trainer.on_rank0(lambda: tsne_visualizations(
            trainer, model, dev_gen, final), full=True)
    return trainer, metrics


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "svhn", "cifar10", "celeba"])
    p.add_argument("--mode", default="local_ep", choices=GMGAN_MODES)
    p.add_argument("--mode-k", default="CONCRETE", choices=MODE_KS)
    p.add_argument("--n-coms", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="the dataset's files (omit for the synthetic "
                        "fallback; 'structured' for the learnable "
                        "labeled family)")
    p.add_argument("--data-pipeline", default=None,
                   choices=["resident", "host"])
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
                   help="cadence of the grids and the clustering accuracy")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    add_failure_flags(p)
    add_parallel_flags(p)
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("n_coms", args.n_coms),
                                   ("compute_dtype", args.compute_dtype),
                                   ("accum_steps", args.accum_steps),
                                   ("batch_size", args.batch_size),
                                   ("dim", args.dim)) if v}
    run(args.dataset, args.mode, iters=args.iters, data_dir=args.data_dir,
        outdir=args.outdir, run_dir=args.run_dir, seed=args.seed,
        checkpoint_every=args.checkpoint_every, eval_every=args.eval_every,
        data_pipeline=args.data_pipeline, chunk_size=args.chunk_size,
        device=args.device, mode_k=args.mode_k, **failure_kwargs(args),
        **parallel_kwargs(args), **overrides)


if __name__ == "__main__":
    main()
