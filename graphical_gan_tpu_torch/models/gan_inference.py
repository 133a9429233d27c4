"""Model family 1, GAN inference: the serving forwards
(``graphical_gan_tpu/models/gan_inference.py:57-64, 210-224``).

``sample``, ``encode`` and ``reconstruct`` are pure functions of a
``{name: tensor}`` params dict with the JAX package's names and shapes, so
parameters come either from :meth:`GanInferenceModel.init` or from a JAX
checkpoint (``train/checkpoint.py: params_from_jax``). The losses and the
discriminator forward come with the training slice; ``init`` still makes the
discriminator's parameters, so its key set equals the JAX ``init``'s.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from graphical_gan_tpu_torch.core.config import (
    VEGAN_CODE_MODES, GanInferenceConfig)
from graphical_gan_tpu_torch.models import networks
from graphical_gan_tpu_torch.models.common import normalize_input
from graphical_gan_tpu_torch.ops import initializers as inits

Params = Dict[str, torch.Tensor]

# (init kind, shape, fan arguments): 'conv' / 'deconv' filters and 'linear'
# weights draw scaled-uniform values; 'zeros' and 'ones' are constants.
_Spec = Tuple[str, Tuple[int, ...], Tuple]


def _conv(specs, name, cin, cout, k=5, stride=2):
    specs[name + ".Filters"] = ("conv", (k, k, cin, cout), (cin, cout, k, stride))
    specs[name + ".Biases"] = ("zeros", (cout,), ())


def _deconv(specs, name, cin, cout, k=5, stride=2):
    specs[name + ".Filters"] = ("deconv", (k, k, cout, cin), (cin, cout, k, stride))
    specs[name + ".Biases"] = ("zeros", (cout,), ())


def _linear(specs, name, din, dout):
    specs[name + ".W"] = ("linear", (din, dout), (din, dout))
    specs[name + ".b"] = ("zeros", (dout,), ())


def _bn(specs, name, c):
    specs[name + ".offset"] = ("zeros", (c,), ())
    specs[name + ".scale"] = ("ones", (c,), ())


class GanInferenceModel:
    GEN_PLAYER = ("Generator", "Extractor")
    DISC_PLAYER = ("Discriminator",)

    def __init__(self, cfg: GanInferenceConfig):
        networks.check_supported(cfg)
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> Dict[str, _Spec]:
        """Every parameter the JAX ``init`` makes, by name."""
        cfg = self.cfg
        dim, ch, dl = cfg.dim, cfg.data.channels, cfg.dim_latent
        feat = 4 * 4 * 4 * dim
        s: Dict[str, _Spec] = {}
        _conv(s, "Extractor.1", ch, dim)
        _conv(s, "Extractor.2", dim, 2 * dim)
        if cfg.bn:
            _bn(s, "Extractor.BN2", 2 * dim)
        _conv(s, "Extractor.3", 2 * dim, 4 * dim)
        if cfg.bn:
            _bn(s, "Extractor.BN3", 4 * dim)
        _linear(s, "Extractor.Output", feat, dl)
        _linear(s, "Generator.Input", dl, feat)
        if cfg.bn:
            _bn(s, "Generator.BN1", feat)
        _deconv(s, "Generator.2", 4 * dim, 2 * dim)
        if cfg.bn:
            _bn(s, "Generator.BN2", 2 * dim)
        _deconv(s, "Generator.3", 2 * dim, dim)
        if cfg.bn:
            _bn(s, "Generator.BN3", dim)
        _deconv(s, "Generator.5", dim, ch)
        if cfg.mode in VEGAN_CODE_MODES:  # networks.discriminator_z
            widths = [dl, 1024, 512, 256, 256]
            names = ["Input", "2", "3", "4"]
            for i, n in enumerate(names):
                _linear(s, f"Discriminator.{n}", widths[i], widths[i + 1])
                if cfg.bn:
                    _bn(s, f"Discriminator.BN{i + 1}", widths[i + 1])
            _linear(s, "Discriminator.Output", 256, 1)
        elif cfg.has_discriminator:  # networks.discriminator_xz, 32x32
            _conv(s, "Discriminator.1", ch, dim)
            _conv(s, "Discriminator.2", dim, 2 * dim)
            _conv(s, "Discriminator.3", 2 * dim, 4 * dim)
            _linear(s, "Discriminator.z1", dl, 512)
            _linear(s, "Discriminator.zx1", feat + 512, 512)
            _linear(s, "Discriminator.Output", 512, 1)
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> Params:
        """Fresh parameters with the JAX names, shapes and init statistics,
        drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
        (so the values differ from JAX's for the same seed)."""
        from graphical_gan_tpu_torch.core.device import resolve_device
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        params: Params = {}
        for name, (kind, shape, fan) in self.param_specs().items():
            if kind == "zeros":
                params[name] = torch.zeros(shape, device=dev)
            elif kind == "ones":
                params[name] = torch.ones(shape, device=dev)
            else:
                if kind == "conv":
                    stdev = inits.he_or_glorot_stdev(
                        *inits.conv_fans(*fan), he_init=True)
                elif kind == "deconv":
                    stdev = inits.he_or_glorot_stdev(
                        *inits.deconv_fans(*fan), he_init=True)
                else:
                    stdev = inits.linear_stdev(None, *fan)
                params[name] = inits.scaled_uniform(stdev, shape, gen)
        return params

    # -- serving forwards -----------------------------------------------------

    def normalize(self, raw: torch.Tensor) -> torch.Tensor:
        return normalize_input(self.cfg, raw, self.compute_dtype)

    def sample(self, params: Params, noise: torch.Tensor) -> torch.Tensor:
        """Generator forward from given codes (in the codes' dtype)."""
        x, _, _ = networks.generator(self.cfg, params, noise)
        return x

    def reconstruct(self, params: Params, raw_x: torch.Tensor) -> torch.Tensor:
        q_z, _, _ = networks.extractor(self.cfg, params, self.normalize(raw_x))
        rec_x, _, _ = networks.generator(self.cfg, params, q_z)
        return rec_x

    def encode(self, params: Params, raw_x: torch.Tensor) -> torch.Tensor:
        q_z, _, _ = networks.extractor(self.cfg, params, self.normalize(raw_x))
        return q_z
