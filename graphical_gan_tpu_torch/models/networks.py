"""Generator, extractor and joint discriminator of the GAN-inference
family, 32x32 datasets (``graphical_gan_tpu/models/networks.py:66-81,
101-163, 205-264``).

Layer names, widths, BN placement and activations are the JAX package's.
Images are NHWC inside; the flatten before ``Extractor.Output`` and the
reshape after ``Generator.Input`` are in NHWC order, as there; the boundary
vectors are flat NCHW (``ops/layout.py``).

This slice ports the cifar10/svhn networks with ``type_q='no_std'`` (what
wali-gp uses); the other datasets and posterior heads raise
``NotImplementedError``. Dropout is the identity, as in the reference's
graphs (``ops/activations.py: dropout``), so the discriminator draws no
random numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from graphical_gan_tpu_torch.models.common import bn_act
from graphical_gan_tpu_torch.ops import (
    conv2d, deconv2d, dropout, flatten_image, leaky_relu, linear,
    unflatten_image)

Params = Dict[str, torch.Tensor]
DATASETS = ("cifar10", "svhn")


def check_supported(cfg) -> None:
    if cfg.dataset not in DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r}: the port's first slice serves the "
            f"32x32 networks ({', '.join(DATASETS)}); mnist and celeba come "
            "with the rest of family 1 in a later slice")
    if cfg.type_q != "no_std":
        raise NotImplementedError(
            f"type_q {cfg.type_q!r}: the port's first slice has the no_std "
            "posterior head only; learn_std and fix_std come with the rest "
            "of family 1 in a later slice")


def generator(cfg, params: Params, noise: torch.Tensor
              ) -> Tuple[torch.Tensor, None, None]:
    check_supported(cfg)
    return _generator_32(cfg, params, noise)


def _generator_32(cfg, params: Params, noise: torch.Tensor):
    """``gan_inference_cifar10.py:135-155``: tanh output."""
    dim = cfg.dim
    h = linear(params, "Generator.Input", noise)
    h = bn_act(cfg.bn, params, "Generator.BN1", h, "relu", axes=[0])
    h = h.reshape(-1, 4, 4, 4 * dim)

    h = deconv2d(params, "Generator.2", h)
    h = bn_act(cfg.bn, params, "Generator.BN2", h, "relu")

    h = deconv2d(params, "Generator.3", h)
    h = bn_act(cfg.bn, params, "Generator.BN3", h, "relu")

    h = deconv2d(params, "Generator.5", h)
    return flatten_image(torch.tanh(h)), None, None


def extractor(cfg, params: Params, x_flat: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                         Optional[torch.Tensor]]:
    """Posterior network q(z|x): (z, mean, std); mean and std are None for
    the no_std head."""
    check_supported(cfg)
    hgt, wdt = cfg.data.image_hw
    x = unflatten_image(x_flat, cfg.data.channels, hgt, wdt)
    h = extractor_front(cfg, params, x)
    return extractor_back(cfg, params, h)


def extractor_front(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Convs 1-2 (+BN2) of the extractor."""
    h = conv2d(params, "Extractor.1", x, stride=2, act="leaky_relu")
    h = conv2d(params, "Extractor.2", h, stride=2)
    return bn_act(cfg.bn, params, "Extractor.BN2", h, "leaky_relu")


def extractor_back(cfg, params: Params, h: torch.Tensor):
    """Conv 3 (+BN3) and the no_std head of the extractor."""
    h = conv2d(params, "Extractor.3", h, stride=2)
    h = bn_act(cfg.bn, params, "Extractor.BN3", h, "leaky_relu")
    h = h.reshape(-1, 4 * 4 * 4 * cfg.dim)
    return linear(params, "Extractor.Output", h), None, None


def discriminator_xz(cfg, params: Params, x_flat: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """Joint discriminator on (data, code) pairs: [B] scores
    (``gan_inference_cifar10.py:232-259``)."""
    check_supported(cfg)
    hgt, wdt = cfg.data.image_hw
    x = unflatten_image(x_flat, cfg.data.channels, hgt, wdt)
    h = discriminator_x_trunk(cfg, params, x)
    return discriminator_xz_head(cfg, params, h, z)


def discriminator_x_trunk(cfg, params: Params, x: torch.Tensor
                          ) -> torch.Tensor:
    """Three k5 s2 convs with leaky ReLU (K1) and dropout; the flattened
    [B, 4*4*4*dim] feature."""
    dr = cfg.dropout_rate
    h = x
    for i in (1, 2, 3):
        h = conv2d(params, f"Discriminator.{i}", h, stride=2,
                   act="leaky_relu")
        h = dropout(h, dr)
    return h.reshape(-1, 4 * 4 * 4 * cfg.dim)


def discriminator_xz_head(cfg, params: Params, h_feat: torch.Tensor,
                          z: torch.Tensor) -> torch.Tensor:
    """The z branch, the concat, the zx layer and the output."""
    dr = cfg.dropout_rate
    hz = dropout(leaky_relu(linear(params, "Discriminator.z1", z)), dr)
    h = torch.cat([h_feat, hz], dim=1)
    h = dropout(leaky_relu(linear(params, "Discriminator.zx1", h)), dr)
    return linear(params, "Discriminator.Output", h).reshape(-1)
