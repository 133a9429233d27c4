"""Minibatch discrimination and the ladder combinator
(``graphical_gan_tpu/ops/special.py``): ``tflib/ops/minibatch.py:16-44``
(Salimans et al.'s minibatch features) and ``tflib/ops/combination.py:
6-30`` (the ladder network's gated combination). No reference entry script
uses them; they are plain tensor math with autograd's gradients, as the
JAX package computes them in plain ``jnp``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

LADDER_ZEROS = ("a1", "a3", "a4", "c1", "c3", "c4", "b1")
LADDER_ONES = ("a2", "c2")


def minibatch_layer(params: Dict[str, torch.Tensor], name: str,
                    x: torch.Tensor) -> torch.Tensor:
    """x [B, num_inputs] -> [B, num_inputs + num_kernels]: x and, per
    kernel, the sum over the other items of exp(-L1 distance) of their
    ``name.W`` ``[num_inputs, num_kernels, dim_per_kernel]`` projections,
    plus ``name.b``."""
    w, b = params[name + ".W"], params[name + ".b"]
    act = torch.tensordot(x, w, dims=([1], [0]))  # [B, K, D]
    # pairwise |a_i - a_j| summed over D, 1e6 on the diagonal
    # (minibatch.py:40: the eye mask removes self-similarity)
    diff = act[:, :, :, None] - act.permute(1, 2, 0)[None, :, :, :]
    abs_dif = torch.sum(torch.abs(diff), dim=2)  # [B, K, B]
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    abs_dif = abs_dif + 1e6 * eye[:, None, :]
    f = torch.sum(torch.exp(-abs_dif), dim=2) + b[None, :]
    return torch.cat([x, f], dim=1)


def minibatch_specs(name: str, num_inputs: int, num_kernels: int,
                    dim_per_kernel: int) -> Dict[str, Tuple]:
    return {name + ".W": ("scaled_uniform",
                          (num_inputs, num_kernels, dim_per_kernel),
                          (math.sqrt(2.0 / num_inputs),)),
            name + ".b": ("zeros", (num_kernels,), ())}


def ladder(params: Dict[str, torch.Tensor], name: str,
           inputs: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """A sigmoid-gated blend of the lateral z and the top-down u."""
    p = {k: params[f"{name}.{k}"] for k in LADDER_ZEROS + LADDER_ONES}
    z_lat, u = inputs
    sigval = torch.sigmoid(p["c1"] + p["c2"] * z_lat + p["c3"] * u
                           + p["c4"] * z_lat * u)
    return (p["a1"] + p["a2"] * z_lat + p["b1"] * sigval + p["a3"] * u
            + p["a4"] * z_lat * u)


def ladder_specs(name: str, input_dim: int) -> Dict[str, Tuple]:
    specs = {f"{name}.{k}": ("zeros", (input_dim,), ())
             for k in LADDER_ZEROS}
    specs.update({f"{name}.{k}": ("ones", (input_dim,), ())
                  for k in LADDER_ONES})
    return specs
