"""Weight initialization (``graphical_gan_tpu/ops/initializers.py``).

The scaled-uniform family of the reference op library: samples are uniform
on ``[-stdev*sqrt(3), +stdev*sqrt(3)]``. The reference ran under Python 2,
whose ``int / int`` floors; ``py2_div`` keeps that fan arithmetic. Draws come
from an explicit ``torch.Generator``, so they differ from JAX's for the same
seed; the statistics are the same.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

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


def init_params(specs: Dict[str, Tuple[str, Tuple[int, ...], Tuple]],
                seed: int = 0,
                device: Union[str, torch.device] = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """Fresh parameters from ``{name: (kind, shape, fan arguments)}``, drawn
    in the specs' order from a ``torch.Generator`` seeded with ``seed`` on
    ``device``: 'conv' / 'deconv' filters (He: ``conv_fans`` /
    ``deconv_fans`` of (in, out, k, stride)) and 'linear' weights (Glorot:
    (in, out)) scaled-uniform, 'zeros' and 'ones' constants."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape, fan) in specs.items():
        if kind == "zeros":
            params[name] = torch.zeros(shape, device=dev)
        elif kind == "ones":
            params[name] = torch.ones(shape, device=dev)
        else:
            if kind == "conv":
                stdev = he_or_glorot_stdev(*conv_fans(*fan), he_init=True)
            elif kind == "deconv":
                stdev = he_or_glorot_stdev(*deconv_fans(*fan), he_init=True)
            else:
                stdev = linear_stdev(None, *fan)
            params[name] = scaled_uniform(stdev, shape, gen)
    return params
