"""Rebuild a model from a run directory and restore its parameters
(``graphical_gan_tpu/tools/generate.py:60-121``).

The port restores family-1 (gan_inference) run directories, every
dataset and mode, from npz checkpoints; the GMGAN and SSGAN families, the
orbax format and the pipeline-parallel packed layout come in later slices.
Sample grids (the ``generate`` tool itself) come with the report tools.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields as dc_fields
from typing import Dict, Tuple, Union

import numpy as np
import torch

from graphical_gan_tpu_torch.core.config import GanInferenceConfig
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib


def detect_family(cfg_dict: dict) -> str:
    if "mode_k" in cfg_dict or "n_coms" in cfg_dict:
        return "gmgan"
    if "pos_mode" in cfg_dict or "ali_mode" in cfg_dict \
            or "seq_len" in cfg_dict:
        return "ssgan"
    return "gan_inference"


def rebuild(run_dir: str) -> Tuple[str, GanInferenceConfig,
                                   GanInferenceModel]:
    """(family, cfg, model) from a run directory's ``config.json``."""
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    family = detect_family(cfg_dict)
    if family != "gan_inference":
        raise NotImplementedError(
            f"family {family!r}: the port serves gan_inference runs; gmgan "
            "and ssgan come in later slices")
    names = {f.name for f in dc_fields(GanInferenceConfig)}
    # JSON turns tuples into lists; restore them so the config is the same
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg_dict.items() if k in names}
    cfg = GanInferenceConfig(**kw)
    return family, cfg, GanInferenceModel(cfg)


def restore_params(model: GanInferenceModel, ckpt_path: str,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(params on ``device``, extra) from an npz checkpoint written by the
    JAX trainer (a whole TrainState) or by ``save_params``. Every parameter
    the model has must be there with its shape."""
    flat, extra = ckpt_lib.load_raw(ckpt_path)
    if "k:packed" in flat:
        raise NotImplementedError(
            f"{ckpt_path!r} holds a pipeline-parallel packed state; the port "
            "reads the standard layout (pp comes in a later slice)")
    raw = ckpt_lib.params_of(flat)
    for name, (_, shape, _) in model.param_specs().items():
        if name not in raw:
            raise KeyError(f"checkpoint {ckpt_path!r} has no parameter "
                           f"{name!r}")
        if tuple(np.shape(raw[name])) != tuple(shape):
            raise ValueError(f"shape mismatch for {name!r}: checkpoint "
                             f"{np.shape(raw[name])} vs model {shape}")
    return ckpt_lib.params_from_jax(raw, device), extra
