"""Serving entries (``graphical_gan_tpu/serve/export.py:53-146``).

Each entry is ``fn(params, seed, *inputs) -> output`` over tensors, with
``example`` inputs (numpy zeros at the config's batch size) that give the
input shapes. ``seed`` is the request's seed: the image entries draw what the model
draws (celeba's dequantization noise, a learn/fix_std posterior's eps) from
a ``torch.Generator`` seeded with it, on the inputs' device, so an exact
request is reproducible, as the JAX package's ``call(key, *inputs)`` is.

Per family the sampler is ``fn(params, seed, *inputs) -> images``:

- gan_inference: ``noise [n, dim_latent]``;
- gmgan: ``k_onehot [n, n_coms], noise [n, dim_latent]``.

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
}

#: what the entry's single output array is
ENTRY_OUTPUT = {"sampler": "images", "reconstructor": "images",
                "encoder": "latents", "cluster": "probs"}


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
    else:
        raise NotImplementedError(
            f"family {family!r} is served from a later slice of the port")
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

    method = {"encoder": model.encode, "reconstructor": model.reconstruct,
              "cluster": getattr(model, "cluster_probs", None)}[entry]

    def fn(params, seed, raw_x):
        gen = torch.Generator(device=raw_x.device)
        gen.manual_seed(int(seed))
        return method(params, raw_x, generator=gen)
    cfg = model.cfg
    example = (np.zeros((cfg.batch_size, cfg.data.output_dim), np.float32),)
    return fn, example, ["image"]
