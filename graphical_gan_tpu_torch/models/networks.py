"""Generators, extractors and discriminators of the GAN-inference family
(``graphical_gan_tpu/models/networks.py``): mnist (28x28, sigmoid output,
the 8x8 -> 7x7 crop, BN inside D), cifar10/svhn (32x32, tanh output) and
celeba (64x64, four stages, no BN), the ``no_std`` / ``learn_std`` /
``fix_std`` posterior heads and the vegan family's code discriminator.

Layer names, widths, BN placement and activations are the JAX package's.
Images are NHWC inside; the flatten before ``Extractor.Output`` and the
reshape after ``Generator.Input`` are in NHWC order, as there; the boundary
vectors are flat NCHW (``ops/layout.py``). Dropout is the identity, as in
the reference's graphs (``ops/activations.py: dropout``).

Random draws (the posterior's ``eps``, the code discriminator's Gaussian
noise) come from a :class:`Draws`: the tensor of that name when the caller
passed one in (the parity tests pass JAX's), else a fresh draw from its
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from graphical_gan_tpu_torch.models.common import Draws, bn_act
from graphical_gan_tpu_torch.ops import (
    conv2d, deconv2d, dropout, flatten_image, gaussian_noise, leaky_relu,
    linear, relu, unflatten_image)

Params = Dict[str, torch.Tensor]
Posterior = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
# generators

def generator(cfg, params: Params, noise: torch.Tensor
              ) -> Tuple[torch.Tensor, None, None]:
    """Flat-image generator; dispatches on ``cfg.dataset``."""
    if cfg.dataset == "mnist":
        return _generator_28(cfg, params, noise)
    if cfg.dataset in ("cifar10", "svhn"):
        return _generator_32(cfg, params, noise)
    if cfg.dataset == "celeba":
        return _generator_64(cfg, params, noise)
    raise ValueError(cfg.dataset)


def _generator_28(cfg, params: Params, noise: torch.Tensor):
    """``gan_inference_mnist.py:122-144``, with the 8x8 -> 7x7 crop."""
    dim = cfg.dim
    h = linear(params, "Generator.Input", noise)
    h = bn_act(cfg.bn, params, "Generator.BN1", h, "relu", axes=[0])
    h = h.reshape(-1, 4, 4, 4 * dim)

    h = deconv2d(params, "Generator.2", h)
    h = bn_act(cfg.bn, params, "Generator.BN2", h, "relu")

    h = h[:, :7, :7, :].contiguous()  # the reference crops NCHW [:, :, :7, :7]

    h = deconv2d(params, "Generator.3", h)
    h = bn_act(cfg.bn, params, "Generator.BN3", h, "relu")

    h = deconv2d(params, "Generator.5", h)
    return flatten_image(torch.sigmoid(h)), None, None


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


def _generator_64(cfg, params: Params, noise: torch.Tensor):
    """``gan_inference_face.py:78-95``: four deconvs, no BN."""
    dim = cfg.dim_g or cfg.dim
    h = relu(linear(params, "Generator.Input", noise))
    h = h.reshape(-1, 4, 4, 8 * dim)
    h = relu(deconv2d(params, "Generator.2", h))
    h = relu(deconv2d(params, "Generator.3", h))
    h = relu(deconv2d(params, "Generator.4", h))
    h = torch.tanh(deconv2d(params, "Generator.5", h))
    return flatten_image(h), None, None


# ---------------------------------------------------------------------------
# extractors (inference networks)

def extractor(cfg, params: Params, x_flat: torch.Tensor,
              draws: Optional[Draws] = None, eps_name: str = "eps_q"
              ) -> Posterior:
    """Posterior network q(z|x): (z, mean, std) honouring ``type_q``
    (``gan_inference_mnist.py:146-180``); the stochastic heads draw their
    ``eps`` [B, z] f32 under ``eps_name``."""
    hgt, wdt = cfg.data.image_hw
    x = unflatten_image(x_flat, cfg.data.channels, hgt, wdt)
    if cfg.dataset == "celeba":
        h = x
        for i in (1, 2, 3, 4):
            h = conv2d(params, f"Extractor.{i}", h, stride=2,
                       act="leaky_relu")
        h = h.reshape(h.shape[0], -1)
        # face.py:114: no stochastic head
        return linear(params, "Extractor.Output", h), None, None
    h = extractor_front(cfg, params, x)
    return extractor_back(cfg, params, h, draws, eps_name)


def extractor_front(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Convs 1-2 (+BN2) of the extractor."""
    h = conv2d(params, "Extractor.1", x, stride=2, act="leaky_relu")
    h = conv2d(params, "Extractor.2", h, stride=2)
    return bn_act(cfg.bn, params, "Extractor.BN2", h, "leaky_relu")


def extractor_back(cfg, params: Params, h: torch.Tensor,
                   draws: Optional[Draws] = None, eps_name: str = "eps_q"
                   ) -> Posterior:
    """Conv 3 (+BN3) and the ``type_q`` head of the extractor."""
    h = conv2d(params, "Extractor.3", h, stride=2)
    h = bn_act(cfg.bn, params, "Extractor.BN3", h, "leaky_relu")
    h = h.reshape(-1, 4 * 4 * 4 * cfg.dim)
    batch = h.shape[0]
    if cfg.type_q == "learn_std":
        std = torch.exp(linear(params, "Extractor.Std", h))
    elif cfg.type_q == "fix_std":
        std = torch.full((batch, cfg.dim_latent), cfg.std,
                         dtype=torch.float32, device=h.device)
    else:
        std = None
    mean_or_z = linear(params, "Extractor.Output", h)
    if std is None:
        return mean_or_z, None, None
    draws = draws or Draws()
    eps = draws.normal(eps_name, mean_or_z.shape, torch.float32, h.device)
    return mean_or_z + eps * std, mean_or_z, std


# ---------------------------------------------------------------------------
# discriminators

def discriminator_xz(cfg, params: Params, x_flat: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """Joint discriminator on (data, code) pairs: [B] scores, with each
    dataset's topology."""
    hgt, wdt = cfg.data.image_hw
    x = unflatten_image(x_flat, cfg.data.channels, hgt, wdt)
    dr = cfg.dropout_rate
    if cfg.dataset == "mnist":
        # gan_inference_mnist.py:217-252: BN in the D convs, a 2-layer z
        # branch and a 2-layer zx trunk
        h = conv2d(params, "Discriminator.1", x, stride=2, act="leaky_relu")
        h = conv2d(params, "Discriminator.2", h, stride=2)
        h = bn_act(cfg.bn, params, "Discriminator.BN2", h, "leaky_relu")
        h = conv2d(params, "Discriminator.3", h, stride=2)
        h = bn_act(cfg.bn, params, "Discriminator.BN3", h, "leaky_relu")
        h = h.reshape(-1, 4 * 4 * 4 * cfg.dim)
        hz = dropout(leaky_relu(linear(params, "Discriminator.z1", z)), dr)
        # the reference names this Linear 'Discriminator.2' too (mnist:238);
        # its keys (.W, .b) sit beside the conv's (.Filters, .Biases)
        hz = dropout(leaky_relu(linear(params, "Discriminator.2", hz)), dr)
        h = torch.cat([h, hz], dim=1)
        h = dropout(leaky_relu(linear(params, "Discriminator.zx1", h)), dr)
        h = dropout(leaky_relu(linear(params, "Discriminator.zx2", h)), dr)
        return linear(params, "Discriminator.Output", h).reshape(-1)
    if cfg.dataset in ("cifar10", "svhn"):
        h = discriminator_x_trunk(cfg, params, x)
        return discriminator_xz_head(cfg, params, h, z)
    if cfg.dataset == "celeba":
        # gan_inference_face.py:119-146: four conv stages
        h = x
        for i in (1, 2, 3, 4):
            h = dropout(conv2d(params, f"Discriminator.{i}", h, stride=2,
                               act="leaky_relu"), dr)
        h = h.reshape(h.shape[0], -1)
        return discriminator_xz_head(cfg, params, h, z)
    raise ValueError(cfg.dataset)


def discriminator_x_trunk(cfg, params: Params, x: torch.Tensor
                          ) -> torch.Tensor:
    """The cifar10/svhn trunk: three k5 s2 convs with leaky ReLU (K1) and
    dropout; the flattened [B, 4*4*4*dim] feature."""
    dr = cfg.dropout_rate
    h = x
    for i in (1, 2, 3):
        h = conv2d(params, f"Discriminator.{i}", h, stride=2,
                   act="leaky_relu")
        h = dropout(h, dr)
    return h.reshape(-1, 4 * 4 * 4 * cfg.dim)


def discriminator_xz_head(cfg, params: Params, h_feat: torch.Tensor,
                          z: torch.Tensor) -> torch.Tensor:
    """The z branch, the concat, the zx layer and the output (cifar10, svhn,
    celeba)."""
    dr = cfg.dropout_rate
    hz = dropout(leaky_relu(linear(params, "Discriminator.z1", z)), dr)
    h = torch.cat([h_feat, hz], dim=1)
    h = dropout(leaky_relu(linear(params, "Discriminator.zx1", h)), dr)
    return linear(params, "Discriminator.Output", h).reshape(-1)


def discriminator_z(cfg, params: Params, z: torch.Tensor,
                    draws: Optional[Draws] = None, prefix: str = "d_noise"
                    ) -> torch.Tensor:
    """Code-space discriminator of the vegan family
    (``gan_inference_mnist.py:184-211``): Gaussian-noise layers and an MLP.
    The four noise layers draw ``{prefix}0`` .. ``{prefix}3`` in the
    activations' dtype."""
    draws = draws or Draws()

    def noise(h, i, std):
        eps = draws.normal(f"{prefix}{i}", h.shape, h.dtype, h.device)
        return gaussian_noise(h, std, noise=eps)

    h = noise(z, 0, 0.3)
    widths = ("Input", "2", "3", "4")
    for i, name in enumerate(widths):
        h = linear(params, f"Discriminator.{name}", h)
        h = bn_act(cfg.bn, params, f"Discriminator.BN{i + 1}", h,
                   "leaky_relu", axes=[0])
        if i < 3:
            h = noise(h, i + 1, 0.5)
    return linear(params, "Discriminator.Output", h).reshape(-1)
