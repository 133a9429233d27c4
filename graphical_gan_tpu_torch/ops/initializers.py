"""Weight initialization (``graphical_gan_tpu/ops/initializers.py``).

The scaled-uniform family of the reference op library: samples are uniform
on ``[-stdev*sqrt(3), +stdev*sqrt(3)]``. The reference ran under Python 2,
whose ``int / int`` floors; ``py2_div`` keeps that fan arithmetic. Draws come
from an explicit ``torch.Generator``, so they differ from JAX's for the same
seed; the statistics are the same.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def py2_div(a, b):
    """Python-2 division semantics: floor for int/int, true otherwise."""
    if isinstance(a, int) and isinstance(b, int):
        return a // b
    return a / b


def scaled_uniform(stdev: float, shape: Sequence[int],
                   generator: torch.Generator, gain: float = 1.0,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U(-stdev*sqrt(3), stdev*sqrt(3)) * gain, drawn on the generator's
    device."""
    bound = stdev * math.sqrt(3.0)
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return gain * (u * (2 * bound) - bound)


def linear_stdev(initialization, input_dim: int, output_dim: int) -> float:
    """Per-scheme stdevs for dense layers (``tflib/ops/linear.py:48-75``)."""
    if initialization == "lecun":
        return math.sqrt(1.0 / input_dim)
    if initialization in ("glorot", None):
        return math.sqrt(2.0 / (input_dim + output_dim))
    if initialization == "he":
        return math.sqrt(2.0 / input_dim)
    if initialization == "glorot_he":
        return math.sqrt(4.0 / (input_dim + output_dim))
    raise ValueError(f"Invalid initialization {initialization!r}")


def conv_fans(input_dim: int, output_dim: int, filter_size: int, stride: int,
              masked: bool = False) -> Tuple[float, float]:
    """``tflib/ops/conv2d.py:62-67`` (with py2 int division)."""
    fan_in = input_dim * filter_size ** 2
    fan_out = py2_div(output_dim * filter_size ** 2, stride ** 2)
    if masked:
        fan_in /= 2.0
        fan_out /= 2.0
    return fan_in, fan_out


def deconv_fans(input_dim: int, output_dim: int, filter_size: int, stride: int
                ) -> Tuple[float, float]:
    """Transpose-conv fan swap (``tflib/ops/deconv2d.py:51-52``)."""
    fan_in = py2_div(input_dim * filter_size ** 2, stride ** 2)
    fan_out = output_dim * filter_size ** 2
    return fan_in, fan_out


def he_or_glorot_stdev(fan_in: float, fan_out: float, he_init: bool) -> float:
    """``tflib/ops/conv2d.py:69-72``: 'he' here is sqrt(4/(fi+fo))."""
    if he_init:
        return math.sqrt(4.0 / (fan_in + fan_out))
    return math.sqrt(2.0 / (fan_in + fan_out))
