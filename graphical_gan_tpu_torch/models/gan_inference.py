"""Model family 1, GAN inference (``graphical_gan_tpu/models/
gan_inference.py``): the serving forwards and the wali-gp losses.

``sample``, ``encode``, ``reconstruct``, ``gen_loss`` and ``disc_loss`` are
functions of a ``{name: tensor}`` params dict with the JAX package's names
and shapes, so parameters come either from :meth:`GanInferenceModel.init`
or from a JAX checkpoint (``train/checkpoint.py: params_from_jax``).

The losses compute only what the mode's costs read, which is what XLA keeps
of the JAX graph after dead-code elimination: no ``rec_x`` or ``rec_z``,
and no gradient penalty inside ``gen_loss``. In ``disc_loss`` the extractor
and generator run under ``torch.no_grad()`` (their outputs are constants
of the discriminator's loss). The random draws (``p_z`` in the compute
dtype, the penalty's ``alpha`` in f32) come from a ``torch.Generator``
unless the caller passes them in, as the parity tests do. This slice trains
wali-gp; the other modes raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from graphical_gan_tpu_torch.core.config import (
    VEGAN_CODE_MODES, GanInferenceConfig)
from graphical_gan_tpu_torch.models import networks
from graphical_gan_tpu_torch.models.common import normalize_input
from graphical_gan_tpu_torch.objectives import gan_inference as objs
from graphical_gan_tpu_torch.objectives import penalties
from graphical_gan_tpu_torch.objectives.common import OptSpec, optimizer_for
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

    # -- training losses (wali-gp) --------------------------------------------

    def _check_trainable(self) -> None:
        if self.cfg.mode != "wali-gp":
            raise NotImplementedError(
                f"mode {self.cfg.mode!r}: the port trains wali-gp; the other "
                "modes come with the rest of family 1 (slice 3 of the port)")

    def draw_p_z(self, batch: int, device, generator=None) -> torch.Tensor:
        """The prior codes, N(0, I) in the compute dtype
        (``gan_inference.py:73-75``)."""
        return torch.randn((batch, self.cfg.dim_latent), generator=generator,
                           device=device, dtype=self.compute_dtype)

    def _players(self, params: Params, raw_x: torch.Tensor,
                 p_z: Optional[torch.Tensor], generator=None):
        """(real_x, q_z, p_z, fake_x): E on the data, G on the prior."""
        real_x = self.normalize(raw_x)
        q_z, _, _ = networks.extractor(self.cfg, params, real_x)
        if p_z is None:
            p_z = self.draw_p_z(raw_x.shape[0], raw_x.device, generator)
        fake_x, _, _ = networks.generator(self.cfg, params, p_z)
        return real_x, q_z, p_z, fake_x

    def _graph(self, params: Params, raw_x: torch.Tensor,
               p_z: Optional[torch.Tensor] = None, generator=None,
               players_grad: bool = True) -> Dict[str, torch.Tensor]:
        """The tensors wali-gp's costs read (``gan_inference.py:68-101``
        without ``rec_x`` / ``rec_z``); E and G run under ``no_grad`` when
        ``players_grad`` is False."""
        self._check_trainable()
        with torch.set_grad_enabled(players_grad and torch.is_grad_enabled()):
            real_x, q_z, p_z, fake_x = self._players(params, raw_x, p_z,
                                                     generator)
        d = self.discriminator(params)
        return dict(real_x=real_x, q_z=q_z, p_z=p_z, fake_x=fake_x,
                    disc_real=d(real_x, q_z), disc_fake=d(fake_x, p_z))

    def discriminator(self, params: Params):
        return lambda x, z: networks.discriminator_xz(self.cfg, params, x, z)

    def gradient_penalty(self, params: Params, t: Dict[str, torch.Tensor],
                         alpha: Optional[torch.Tensor] = None,
                         generator=None) -> torch.Tensor:
        """wali-gp's penalty on interpolates of (x, z); ``alpha`` [B, 1]
        f32, drawn from ``generator`` when not given."""
        if alpha is None:
            alpha = torch.rand((t["real_x"].shape[0], 1), generator=generator,
                               device=t["real_x"].device)
        return penalties.gradient_penalty_xz(
            self.discriminator(params), t["real_x"], t["fake_x"], t["q_z"],
            t["p_z"], alpha, self.cfg.gp_lambda)

    def gen_loss(self, params: Params, raw_x: torch.Tensor,
                 p_z: Optional[torch.Tensor] = None, generator=None
                 ) -> Tuple[torch.Tensor, Dict]:
        """The G+E player's loss: ``-mean(D(fake)) + mean(D(real))``."""
        t = self._graph(params, raw_x, p_z, generator)
        g, _ = objs.wali_gp(t["disc_fake"], t["disc_real"], 0.0)
        return g, {"gen_cost": g}

    def disc_loss(self, params: Params, raw_x: torch.Tensor,
                  p_z: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None, generator=None
                  ) -> Tuple[torch.Tensor, Dict]:
        """The D player's loss: ``mean(D(fake)) - mean(D(real)) + GP``."""
        t = self._graph(params, raw_x, p_z, generator, players_grad=False)
        gp = self.gradient_penalty(params, t, alpha, generator)
        _, d = objs.wali_gp(t["disc_fake"], t["disc_real"], gp)
        return d, {"disc_cost": d, "gp": gp}

    # -- optimizer presets ----------------------------------------------------

    def opt_specs(self) -> Tuple[OptSpec, Optional[OptSpec]]:
        """(G+E player's, D player's) optimizer (``gan_inference.py:
        242-255``): wali-gp trains both with the same Adam preset."""
        self._check_trainable()
        spec = optimizer_for("wali_gp")
        return spec, spec
