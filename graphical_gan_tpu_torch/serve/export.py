"""Serving entries (``graphical_gan_tpu/serve/export.py:53-146``).

Each entry is ``fn(params, seed, *inputs) -> output`` over tensors, with
``example`` inputs (numpy zeros at the config's batch size) that give the
input shapes. ``seed`` is the request's seed: the image entries draw what the model
draws (celeba's dequantization noise, a learn/fix_std posterior's eps) from
a ``torch.Generator`` seeded with it, on the inputs' device, so an exact
request is reproducible, as the JAX package's ``call(key, *inputs)`` is.

Per family the sampler is ``fn(params, seed, *inputs) -> images``:

- gan_inference: ``noise [n, dim_latent]``;
- gmgan: ``k_onehot [n, n_coms], noise [n, dim_latent]``;
- ssgan: ``z_l_0 [n, dim_latent_l], z_g [n, dim_latent_g]`` and, for a
  conditional model, one-hot ``labels [n, n_classes]``; the motion chain's
  eps is drawn from the seed. Output: videos [n, LEN, C·H·W].

ssgan's ``reconstructor`` takes raw videos [n, LEN, C·H·W] (and the
one-hot labels of a conditional model).

The artifact export (``torch.export``) waits for a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: deployable entries per family ported so far
ENTRIES = {
    "gan_inference": ("sampler", "encoder", "reconstructor"),
    "gmgan": ("sampler", "encoder", "cluster", "reconstructor"),
    "ssgan": ("sampler", "reconstructor"),
}

#: what the entry's single output array is
ENTRY_OUTPUT = {"sampler": "images", "reconstructor": "images",
                "encoder": "latents", "cluster": "probs"}


def _generator(seed: int, like: torch.Tensor) -> torch.Generator:
    gen = torch.Generator(device=like.device)
    gen.manual_seed(int(seed))
    return gen


def make_sampler(family: str, model) -> Tuple:
    """(fn, example_inputs) for the generator-side entry."""
    cfg = model.cfg
    n = cfg.batch_size
    if family == "gan_inference":
        def fn(params, seed, noise):
            return model.sample(params, noise)
        example = (np.zeros((n, cfg.dim_latent), np.float32),)
    elif family == "gmgan":
        def fn(params, seed, k_onehot, noise):
            return model.sample(params, k_onehot, noise)
        example = (np.zeros((n, cfg.n_coms), np.float32),
                   np.zeros((n, cfg.dim_latent), np.float32))
    elif family == "ssgan":
        def fn(params, seed, z_l_0, z_g, *labels):
            return model.sample(params, z_l_0, z_g,
                                labels[0] if labels else None,
                                _generator(seed, z_l_0))
        example = (np.zeros((n, cfg.dim_latent_l), np.float32),
                   np.zeros((n, cfg.dim_latent_g), np.float32))
        if cfg.conditional:
            example += (np.zeros((n, cfg.n_classes), np.float32),)
    else:
        raise ValueError(f"unknown family {family!r}")
    return fn, example


def make_entry(family: str, model, entry: str = "sampler") -> Tuple:
    """(fn, example_inputs, input_kinds) for a family's serving entry.

    The image entries take RAW-space data as the dataset loaders yield it
    (``model.normalize`` runs inside): ``encoder`` x -> q_z,
    ``reconstructor`` x -> G(E(x)) and, for gmgan, ``cluster`` x -> q(k|x)
    (``gmgan_inference_mnist.py:513-531``). ``input_kinds`` are
    ``"normal"`` / ``"onehot"`` (the server can draw them from a seed) or
    ``"image"`` (the client sends it).
    """
    if entry not in ENTRIES.get(family, ()):
        raise ValueError(f"family {family!r} has no entry {entry!r}; "
                         f"choose from {ENTRIES.get(family, ())}")
    if entry == "sampler":
        from graphical_gan_tpu_torch.serve.server import input_kinds
        fn, example = make_sampler(family, model)
        return fn, example, input_kinds(family, model.cfg)

    cfg = model.cfg
    if family == "ssgan":  # the reconstructor (ENTRIES gates the rest)
        def fn(params, seed, raw_x, *labels):
            return model.reconstruct(params, raw_x,
                                     labels[0] if labels else None)
        example = (np.zeros((cfg.batch_size, cfg.seq_len, cfg.output_dim),
                            np.float32),)
        if not cfg.conditional:
            return fn, example, ["image"]
        return (fn, example + (np.zeros((cfg.batch_size, cfg.n_classes),
                                        np.float32),), ["image", "onehot"])

    method = {"encoder": model.encode, "reconstructor": model.reconstruct,
              "cluster": getattr(model, "cluster_probs", None)}[entry]

    def fn(params, seed, raw_x):
        return method(params, raw_x, generator=_generator(seed, raw_x))
    example = (np.zeros((cfg.batch_size, cfg.data.output_dim), np.float32),)
    return fn, example, ["image"]
