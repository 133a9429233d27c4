"""Elementwise activations and stochastic layers
(``graphical_gan_tpu/ops/activations.py``)."""

from __future__ import annotations

from typing import Optional

import torch

LEAKY_ALPHA = 0.2  # the reference's LeakyReLU slope


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    """``max(alpha*x, x)``, the reference's LeakyReLU."""
    return torch.maximum(alpha * x, x)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def activation(name: Optional[str]):
    """None | 'relu' | 'leaky_relu' -> callable."""
    if name is None:
        return _identity
    if name == "relu":
        return relu
    if name == "leaky_relu":
        return leaky_relu
    raise ValueError(name)


def activation_grad(name: Optional[str], y: torch.Tensor) -> torch.Tensor:
    """d act(u)/du from the pre-activation (or the output: the activations
    are monotone and keep the sign), in y's dtype, as the JAX package's
    ``ops/pallas/fused_norm.py:_act_grad``: y > 0 picks the slope."""
    if name is None:
        return torch.ones_like(y)
    if name == "relu":
        return (y > 0).to(y.dtype)
    if name == "leaky_relu":
        return torch.where(y > 0, 1.0, LEAKY_ALPHA).to(y.dtype)
    raise ValueError(name)


def dropout(x: torch.Tensor, rate: float, training: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; the identity unless ``training=True``. The reference
    never passes ``training`` to ``tf.layers.dropout``, whose TF1 default is
    False, so every dropout layer of the published models is the identity."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def gaussian_noise(x: torch.Tensor, std: float,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Additive Gaussian noise layer, ``x + std·N(0, 1)``
    (``gan_inference_mnist.py:118-120``). The standard normal draw is
    ``noise`` when given (the parity tests pass JAX's), else drawn from
    ``generator`` in x's dtype."""
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
    return x + std * noise.to(x.dtype)


def sample_gumbel(u: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Gumbel(0, 1) samples from uniform draws ``u`` in [0, 1)
    (``gmgan_inference_mnist.py:109-112``): ``-log(-log(u + eps) + eps)``.
    The caller draws ``u`` (by name, ``models/common.py: Draws``)."""
    return -torch.log(-torch.log(u + eps) + eps)
