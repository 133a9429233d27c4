"""Weight initialization (``graphical_gan_tpu/ops/initializers.py``).

The scaled-uniform family of the reference op library: samples are uniform
on ``[-stdev*sqrt(3), +stdev*sqrt(3)]``, plus the ``('uniform', r)`` range,
the SVD orthogonal init, normal draws and constants. The reference ran
under Python 2, whose ``int / int`` floors; ``py2_div`` keeps that fan
arithmetic. Draws come from an explicit ``torch.Generator``, so they differ
from JAX's for the same seed; the statistics are the same.

``init_params`` builds a parameter dict from specs ``{name: (kind, shape,
fan arguments)}``, one init function per kind (``INITS``); the ops'
``*_specs`` functions (``ops/conv.py``, ``ops/linear.py``, ``ops/norm.py``,
``ops/special.py``) write the specs of their parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple, Union

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


def uniform_range(bound: float, shape: Sequence[int],
                  generator: torch.Generator, gain: float = 1.0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``('uniform', range)`` scheme: U(-bound, bound) * gain."""
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return gain * (u * (2 * bound) - bound)


def orthogonal(shape: Sequence[int], generator: torch.Generator,
               gain: float = 1.0, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """SVD orthogonal init (lasagne's, ``tflib/ops/linear.py:79-92``): the
    U or V^T of a normal draw of shape ``(shape[0], prod(shape[1:]))``,
    whichever has that shape, times ``gain``."""
    shape = tuple(shape)
    if len(shape) < 2:
        raise ValueError("orthogonal init needs >=2-D shapes")
    flat = (shape[0], math.prod(shape[1:]))
    a = torch.randn(flat, generator=generator, dtype=torch.float32,
                    device=generator.device)
    u, _, vt = torch.linalg.svd(a, full_matrices=False)
    q = u if tuple(u.shape) == flat else vt
    return (gain * q.reshape(shape)).to(dtype)


def normal(shape: Sequence[int], generator: torch.Generator,
           stddev: float = 1.0, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    return stddev * torch.randn(tuple(shape), generator=generator,
                                dtype=dtype, device=generator.device)


def zeros(shape: Sequence[int], device=None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], device=None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


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


def conv1d_fans(input_dim: int, output_dim: int, filter_size: int,
                stride: int, masked: bool = False) -> Tuple[float, float]:
    """``tflib/ops/conv1d.py:51-56``."""
    fan_in = input_dim * filter_size
    fan_out = py2_div(output_dim * filter_size, stride)
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


def conv3d_fans(input_dim: int, output_dim: int, filter_size: int,
                filter_len: int, stride: int, stride_len: int
                ) -> Tuple[float, float]:
    """``tflib/ops/conv3d.py:20-21``, with the py2 left-to-right
    arithmetic."""
    fan_in = input_dim * filter_size ** 2 * filter_len
    fan_out = py2_div(
        py2_div(output_dim * filter_size ** 2, stride ** 2) * filter_len,
        stride_len)
    return fan_in, fan_out


def he_or_glorot_stdev(fan_in: float, fan_out: float, he_init: bool) -> float:
    """``tflib/ops/conv2d.py:69-72``: 'he' here is sqrt(4/(fi+fo))."""
    if he_init:
        return math.sqrt(4.0 / (fan_in + fan_out))
    return math.sqrt(2.0 / (fan_in + fan_out))


# One init function per parameter kind: ``fn(shape, fan, generator,
# params)``, ``params`` holding what the specs before it drew. The fan
# arguments of each kind:
# - 'conv' / 'conv1d': (in, out, k, stride[, masked[, he_init[, gain]]])
#   (``conv_fans`` / ``conv1d_fans``);
# - 'deconv': (in, out, k, stride[, he_init[, gain]]) (``deconv_fans``);
# - 'conv3d': (in, out, k, k_len, stride, stride_len) (``conv3d_fans``);
# - 'linear': (in, out[, initialization[, gain]]) (``linear_stdev``);
# - 'scaled_uniform': (stdev,); 'uniform': (bound[, gain]);
#   'orthogonal': ([gain]); 'normal': ([stddev]); 'zeros', 'ones': ();
# - 'norms': (name, axes): the L2 norms over ``axes`` of the parameter
#   ``name`` as drawn (weight normalization's ``.g``, ``ops/conv.py:97-104``).
# The filters are He-initialized (``he_init`` True) unless a spec says
# otherwise, dense weights Glorot.


def _options(given: Tuple, defaults: Tuple) -> Tuple:
    """The optional fan arguments ``given``, the rest from ``defaults``."""
    return tuple(given) + tuple(defaults[len(given):])


def _conv_like(fans: Callable, n_fans: int):
    def init(shape, fan, gen, params):
        he_init, gain = _options(fan[n_fans:], (True, 1.0))
        stdev = he_or_glorot_stdev(*fans(*fan[:n_fans]), he_init=he_init)
        return scaled_uniform(stdev, shape, gen, gain)
    return init


def _linear(shape, fan, gen, params):
    initialization, gain = _options(fan[2:], (None, 1.0))
    return scaled_uniform(linear_stdev(initialization, *fan[:2]), shape, gen,
                          gain)


def _norms(shape, fan, gen, params):
    name, axes = fan
    return torch.sqrt(torch.sum(torch.square(params[name]),
                                dim=tuple(axes)))


INITS: Dict[str, Callable] = {
    "conv": _conv_like(conv_fans, 5),
    "conv1d": _conv_like(conv1d_fans, 5),
    "deconv": _conv_like(deconv_fans, 4),
    "conv3d": _conv_like(conv3d_fans, 6),
    "linear": _linear,
    "scaled_uniform": lambda shape, fan, gen, params: scaled_uniform(
        fan[0], shape, gen),
    "uniform": lambda shape, fan, gen, params: uniform_range(
        fan[0], shape, gen, *fan[1:]),
    "orthogonal": lambda shape, fan, gen, params: orthogonal(
        shape, gen, *fan),
    "normal": lambda shape, fan, gen, params: normal(shape, gen, *fan),
    "zeros": lambda shape, fan, gen, params: zeros(shape, gen.device),
    "ones": lambda shape, fan, gen, params: ones(shape, gen.device),
    "norms": _norms,
}


def init_params(specs: Dict[str, Tuple[str, Tuple[int, ...], Tuple]],
                seed: int = 0,
                device: Union[str, torch.device] = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """Fresh parameters from ``{name: (kind, shape, fan arguments)}``,
    drawn in the specs' order from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, each by its kind's function in ``INITS``."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape, fan) in specs.items():
        if kind not in INITS:
            raise ValueError(f"{name}: unknown init kind {kind!r}")
        params[name] = INITS[kind](shape, tuple(fan), gen, params)
    return params
