"""Rebuild a model from a run directory, restore its parameters and write
its grids (``graphical_gan_tpu/tools/generate.py``):

    python -m graphical_gan_tpu_torch.tools.generate --run-dir R \\
        [--ckpt F] [--out DIR] [--data-dir D] [--no-data] [--device cpu]

Family 1 (gan_inference) writes the fixed-noise sample grid and the
interleaved reconstruction grid of the trainer's hook
(``runs/gan_inference.py: make_eval_hooks``); family 2 (gmgan) the
per-component sample grid and the reconstruction grid
(``runs/gmgan.py``); family 3 (ssgan) the sample, reconstruction and
disentanglement montages and GIFs of its hook (``runs/ssgan.py:
make_eval_hook``). The reconstruction (and ssgan's whole hook) needs a dev
batch from the family's loaders (synthetic where the files are absent);
``--no-data`` skips it, which ssgan refuses. Runs restore from npz
checkpoints, sharded ``.orbax`` directories and pipeline runs' packed
rows at any stage count (:func:`restore_params`).
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import fields as dc_fields
from typing import Dict, Tuple, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core import config as config_lib
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib


def detect_family(cfg_dict: dict) -> str:
    if "mode_k" in cfg_dict or "n_coms" in cfg_dict:
        return "gmgan"
    if "pos_mode" in cfg_dict or "ali_mode" in cfg_dict \
            or "seq_len" in cfg_dict:
        return "ssgan"
    return "gan_inference"


def _families():
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    from graphical_gan_tpu_torch.models.gmgan import GMGanModel
    from graphical_gan_tpu_torch.models.ssgan import SSGanModel
    return {"gan_inference": (config_lib.GanInferenceConfig,
                              GanInferenceModel),
            "gmgan": (config_lib.GMGanConfig, GMGanModel),
            "ssgan": (config_lib.SSGanConfig, SSGanModel)}


def rebuild(run_dir: str) -> Tuple[str, object, object]:
    """(family, cfg, model) from a run directory's ``config.json``."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    family = detect_family(cfg_dict)
    cfg_cls, model_cls = _families()[family]
    names = {f.name for f in dc_fields(cfg_cls)}
    # JSON turns tuples into lists; restore them so the config is the same
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg_dict.items() if k in names}
    cfg = cfg_cls(**kw)
    return family, cfg, model_cls(cfg)


def restore_params(model, ckpt_path: str,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(params on ``device``, extra) from any checkpoint either package's
    trainers write (JAX ``:97-118``): a whole TrainState or ``save_params``'
    npz, a sharded ``.orbax`` directory, or a pipeline run's packed rows
    at any stage count (``parallel/pipeline.py: restore_pp_params``).
    Every parameter the model has must be there with its shape."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    shapes = ckpt_lib.leaf_shapes(ckpt_path)
    if "k:packed" in shapes:
        from graphical_gan_tpu_torch.parallel import pipeline as pp
        return pp.restore_pp_params(model, ckpt_path, dev)
    specs = model.param_specs()
    for name, (_, shape, _) in specs.items():
        key = ckpt_lib.PARAMS_PREFIX + name
        if key not in shapes:
            raise KeyError(f"checkpoint {ckpt_path!r} has no parameter "
                           f"{name!r}")
        if tuple(shapes[key]) != tuple(shape):
            raise ValueError(f"shape mismatch for {name!r}: checkpoint "
                             f"{shapes[key]} vs model {shape}")
    if ckpt_lib.is_orbax(ckpt_path):
        from graphical_gan_tpu_torch.train import checkpoint_orbax
        keys = [ckpt_lib.PARAMS_PREFIX + n for n in specs]
        got = checkpoint_orbax.read_leaves(ckpt_path, keys)
        return ({n: got[ckpt_lib.PARAMS_PREFIX + n].to(dev) for n in specs},
                checkpoint_orbax.read_extra(ckpt_path))
    flat, extra = ckpt_lib.load_raw(ckpt_path)
    return ckpt_lib.params_from_jax(ckpt_lib.params_of(flat), dev), extra


class _Shim:
    """What the trainer's eval hooks read: ``params``, ``outf``,
    ``device``, a ``logger`` (ssgan's hook plots ``dev rec l2``) and the
    trainer's ``eval_generator``."""

    def __init__(self, params, outf, device, seed: int = 0):
        from graphical_gan_tpu_torch.report.plot import MetricLogger
        self.params, self.outf, self.device = params, outf, device
        self.seed = seed
        self.logger = MetricLogger()

    def eval_generator(self, salt: int, iteration: int) -> torch.Generator:
        from graphical_gan_tpu_torch.train.trainer import Trainer
        return Trainer.eval_generator(self, salt, iteration)


def _dev_batch(family: str, cfg, data_dir):
    if family == "gmgan":
        from graphical_gan_tpu_torch.runs.gmgan import _loaders
    elif family == "ssgan":
        from graphical_gan_tpu_torch.runs.ssgan import _loaders
    else:
        from graphical_gan_tpu_torch.runs.gan_inference import _loaders
    batch = next(iter(_loaders(cfg, data_dir)[1]()))
    return batch[0] if isinstance(batch, tuple) else batch


def generate(run_dir: str, ckpt: str = None, out: str = None,
             data_dir: str = None, with_data: bool = True,
             device: Union[str, torch.device] = "cuda") -> dict:
    """Write the family's grids for a run directory's checkpoint (the
    latest unless ``ckpt``) into ``out`` (``<run_dir>/generated``)."""
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    dev = resolve_device(device)
    set_numerics()
    family, cfg, model = rebuild(run_dir)
    path = ckpt or ckpt_lib.latest(run_dir)
    if path is None:
        raise FileNotFoundError(f"no ckpt_*.npz under {run_dir}")
    params, extra = restore_params(model, path, dev)
    iteration = int(extra.get("iteration", -1))
    outf = out or os.path.join(run_dir, "generated")
    os.makedirs(outf, exist_ok=True)
    shim = _Shim(params, outf, dev)
    batch = _dev_batch(family, cfg, data_dir) if with_data else None
    if family == "gmgan":
        from graphical_gan_tpu_torch.runs.gmgan import (
            make_recon_hook, make_sample_hook)
        make_sample_hook(model)(shim, iteration)
        if batch is not None:
            make_recon_hook(model, batch)(shim, iteration)
    elif family == "ssgan":
        from graphical_gan_tpu_torch.runs.ssgan import make_eval_hook
        if batch is None:
            raise ValueError("ssgan artifacts need a dev batch (drop "
                             "--no-data)")
        make_eval_hook(model, batch)(shim, iteration)
    else:
        from graphical_gan_tpu_torch.runs.gan_inference import (
            make_eval_hooks)
        make_eval_hooks(model, batch)(shim, iteration)
    return {"family": family, "ckpt": path, "iteration": iteration,
            "outdir": outf, "artifacts": sorted(os.listdir(outf))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run-dir", required=True)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint file (default: the latest in "
                        "--run-dir)")
    p.add_argument("--out", default=None,
                   help="the grids' directory (default: <run-dir>/generated)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--no-data", action="store_true",
                   help="skip the reconstruction grid (it needs a dev "
                        "batch)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    info = generate(args.run_dir, ckpt=args.ckpt, out=args.out,
                    data_dir=args.data_dir, with_data=not args.no_data,
                    device=args.device)
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
