"""Model family 1, GAN inference (``graphical_gan_tpu/models/
gan_inference.py``): ALI, ALICE (-z, -x), VEGAN (and its -wgan-gp, -mmd,
-kl, -ikl, -jsd forms), WALI (-gp) and VAE, on mnist, cifar10, svhn and
celeba.

``sample``, ``encode``, ``reconstruct``, ``gen_loss`` and ``disc_loss`` are
functions of a ``{name: tensor}`` params dict with the JAX package's names
and shapes, so parameters come either from :meth:`GanInferenceModel.init`
or from a JAX checkpoint (``train/checkpoint.py: params_from_jax``).

The chain is the reference's (``gan_inference_cifar10.py:261-287``):
``q_z = E(real_x)``, ``rec_x = G(q_z)``, ``p_z ~ N(0, I)``,
``fake_x = G(p_z)``, ``rec_z = E(fake_x)``, and the discriminator on
(x, z) pairs, or on codes alone for vegan and vegan-wgan-gp. Each loss
computes only what its mode's cost reads, which is what XLA keeps of the
JAX graph after dead-code elimination: ``rec_x`` and ``rec_z`` only where a
reconstruction penalty or the VAE reads them, no gradient penalty inside
``gen_loss``, and in ``disc_loss`` the extractor and generator run under
``torch.no_grad()`` (their outputs are constants of the discriminator's
loss).

Random draws come from a :class:`~models.common.Draws`: a tensor of that
name in ``draws`` when the caller passes one (the parity tests pass JAX's),
else a draw from ``generator``. The names, in the order the JAX graph draws
them: ``dequant`` (celeba's input noise, [B, D] U[0,1) f32), ``eps_q`` (the
learn/fix_std posterior on the data, [B, z] f32), ``p_z`` ([B, z], compute
dtype), ``eps_rec`` (the posterior on fake_x), ``d_real0-3`` and
``d_fake0-3`` (the code discriminator's noise on p_z and on q_z),
``alpha`` ([B, 1] f32, the penalty's interpolation) and ``gp_noise0-3``
(the code discriminator's noise on the interpolates), ``mix_idx`` ([S]
int64) and ``mix_eps`` ([S, z]) for a draw from the aggregated posterior,
``z_prior`` ([S, z]) for one from the prior (S = ``z_samples``).

``fused_gp`` (off by default, as in JAX, which measured it slower) computes
wali-gp's D loss from one batched D apply over [real; fake; interpolates]
(``penalties.wali_gp_fused``) where D couples no rows (``_rowwise_disc``:
cifar10, svhn, celeba); the mnist D, with batch-statistics BN, keeps the
separate applies, as JAX does. The G+E player's loss reads only D's real
and fake scores, which the fused apply gives row for row, so it keeps the
two applies.

Known reference defect, made functional as in the JAX package: the vae
mode's Gaussian likelihood takes mean rec_x and std ``cfg.std``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from graphical_gan_tpu_torch.core import shard_ctx
from graphical_gan_tpu_torch.core.config import (
    VEGAN_CODE_MODES, GanInferenceConfig)
from graphical_gan_tpu_torch.models import networks
from graphical_gan_tpu_torch.models.common import Draws, normalize_input
from graphical_gan_tpu_torch.objectives import gan_inference as objs
from graphical_gan_tpu_torch.objectives import kl, kl_aggregated, mmd
from graphical_gan_tpu_torch.objectives import penalties
from graphical_gan_tpu_torch.objectives.common import OptSpec, optimizer_for
from graphical_gan_tpu_torch.ops import initializers as inits

Params = Dict[str, torch.Tensor]

# (init kind, shape, fan arguments): 'conv' / 'deconv' filters and 'linear'
# weights draw scaled-uniform values; 'zeros' and 'ones' are constants.
_Spec = Tuple[str, Tuple[int, ...], Tuple]

XZ_MODES = ("ali", "alice", "alice-z", "alice-x", "wali", "wali-gp")
# modes whose gen cost reads rec_x = G(q_z), and rec_z = E(G(p_z))
# (``gan_inference.py:111-123``, 180-187)
REC_X_MODES = ("alice", "alice-z", "vegan", "vegan-wgan-gp", "vegan-mmd",
               "vegan-kl", "vegan-ikl", "vegan-jsd", "vae")
REC_Z_MODES = ("alice", "alice-x")
KL_MODES = ("vegan-kl", "vegan-ikl", "vegan-jsd")


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


def encoder_generator_specs(cfg) -> Dict[str, _Spec]:
    """The extractor's and the generator's parameters (``networks.py``), the
    same in families 1 and 2: mnist, cifar10 and svhn (three stages, BN in
    E and G where ``cfg.bn``), celeba (four stages of ``dim_g``, no BN)."""
    ch, dl = cfg.data.channels, cfg.dim_latent
    s: Dict[str, _Spec] = {}
    if cfg.dataset == "celeba":
        # gan_inference_face.py:78-116
        dim = cfg.dim_g or cfg.dim
        widths = [ch, dim, 2 * dim, 4 * dim, 8 * dim]
        for i in range(4):
            _conv(s, f"Extractor.{i + 1}", widths[i], widths[i + 1])
        _linear(s, "Extractor.Output", 4 * 4 * 8 * dim, dl)
        _linear(s, "Generator.Input", dl, 4 * 4 * 8 * dim)
        for i, n in enumerate(["2", "3", "4", "5"]):
            _deconv(s, f"Generator.{n}", widths[4 - i], widths[3 - i])
        return s
    dim = cfg.dim
    feat = 4 * 4 * 4 * dim
    _conv(s, "Extractor.1", ch, dim)
    _conv(s, "Extractor.2", dim, 2 * dim)
    if cfg.bn:
        _bn(s, "Extractor.BN2", 2 * dim)
    _conv(s, "Extractor.3", 2 * dim, 4 * dim)
    if cfg.bn:
        _bn(s, "Extractor.BN3", 4 * dim)
    if cfg.type_q == "learn_std":
        _linear(s, "Extractor.Std", feat, dl)
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
    return s


class GanInferenceModel:
    GEN_PLAYER = ("Generator", "Extractor")
    DISC_PLAYER = ("Discriminator",)
    #: draws only a D update makes (the step indexes them by D update)
    DISC_ONLY_DRAWS = ("alpha", "gp_noise0", "gp_noise1", "gp_noise2",
                       "gp_noise3")

    def __init__(self, cfg: GanInferenceConfig):
        if cfg.dataset not in ("mnist", "cifar10", "svhn", "celeba"):
            raise ValueError(f"unknown gan_inference dataset {cfg.dataset!r}")
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> Dict[str, _Spec]:
        """Every parameter the JAX ``init`` makes, by name."""
        cfg = self.cfg
        ch, dl = cfg.data.channels, cfg.dim_latent
        s = encoder_generator_specs(cfg)
        if cfg.mode in VEGAN_CODE_MODES:  # networks.discriminator_z
            widths = [dl, 1024, 512, 256, 256]
            for i, n in enumerate(["Input", "2", "3", "4"]):
                _linear(s, f"Discriminator.{n}", widths[i], widths[i + 1])
                if cfg.bn:
                    _bn(s, f"Discriminator.BN{i + 1}", widths[i + 1])
            _linear(s, "Discriminator.Output", 256, 1)
        elif cfg.has_discriminator and cfg.dataset == "celeba":
            # gan_inference_face.py:119-146: four stages, no BN
            dd = cfg.dim_d or cfg.dim
            wd = [ch, dd, 2 * dd, 4 * dd, 8 * dd]
            for i in range(4):
                _conv(s, f"Discriminator.{i + 1}", wd[i], wd[i + 1])
            _linear(s, "Discriminator.z1", dl, 512)
            _linear(s, "Discriminator.zx1", 4 * 4 * 8 * dd + 512, 512)
            _linear(s, "Discriminator.Output", 512, 1)
        elif cfg.has_discriminator:
            dim = cfg.dim
            feat = 4 * 4 * 4 * dim
            _conv(s, "Discriminator.1", ch, dim)
            _conv(s, "Discriminator.2", dim, 2 * dim)
            _conv(s, "Discriminator.3", 2 * dim, 4 * dim)
            _linear(s, "Discriminator.z1", dl, 512)
            if cfg.dataset == "mnist":
                if cfg.bn:
                    _bn(s, "Discriminator.BN2", 2 * dim)
                    _bn(s, "Discriminator.BN3", 4 * dim)
                _linear(s, "Discriminator.2", 512, 512)
                _linear(s, "Discriminator.zx2", 512, 512)
            _linear(s, "Discriminator.zx1", feat + 512, 512)
            _linear(s, "Discriminator.Output", 512, 1)
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> Params:
        """Fresh parameters with the JAX names, shapes and init statistics,
        drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
        (so the values differ from JAX's for the same seed)."""
        return inits.init_params(self.param_specs(), seed, device)

    # -- serving forwards -----------------------------------------------------

    def normalize(self, raw: torch.Tensor, draws: Optional[Draws] = None
                  ) -> torch.Tensor:
        return normalize_input(self.cfg, raw, self.compute_dtype, draws)

    def sample(self, params: Params, noise: torch.Tensor) -> torch.Tensor:
        """Generator forward from given codes (in the codes' dtype)."""
        x, _, _ = networks.generator(self.cfg, params, noise)
        return x

    def encode(self, params: Params, raw_x: torch.Tensor, generator=None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """q_z = E(x); celeba's input noise and a stochastic posterior's
        eps come from ``draws`` or ``generator``."""
        d = Draws(draws, generator)
        q_z, _, _ = networks.extractor(self.cfg, params,
                                       self.normalize(raw_x, d), d)
        return q_z

    def reconstruct(self, params: Params, raw_x: torch.Tensor,
                    generator=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        return self.sample(params, self.encode(params, raw_x, generator,
                                               draws))

    # -- training losses ------------------------------------------------------

    def draws(self, p_z=None, alpha=None, generator=None, draws=None
              ) -> Draws:
        given = dict(draws or {})
        if p_z is not None:
            given["p_z"] = p_z
        if alpha is not None:
            given["alpha"] = alpha
        return Draws(given, generator)

    def _graph(self, params: Params, raw_x: torch.Tensor,
               p_z: Optional[torch.Tensor] = None, generator=None,
               players_grad: bool = True,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """The tensors the mode's costs read (``gan_inference.py:68-101``);
        ``players_grad`` True builds the G+E player's graph (with rec_x and
        rec_z where the gen cost reads them), False the D player's, with E
        and G under ``no_grad``."""
        d = draws if isinstance(draws, Draws) else self.draws(
            p_z, None, generator, draws)
        cfg, mode = self.cfg, self.cfg.mode
        gen = players_grad
        t: Dict[str, torch.Tensor] = {}
        with torch.set_grad_enabled(gen and torch.is_grad_enabled()):
            real_x = self.normalize(raw_x, d)
            q_z, t["q_z_mean"], t["q_z_std"] = networks.extractor(
                cfg, params, real_x, d, "eps_q")
            t.update(real_x=real_x, q_z=q_z)
            if gen and mode in REC_X_MODES:
                t["rec_x"], _, _ = networks.generator(cfg, params, q_z)
            if mode in XZ_MODES + VEGAN_CODE_MODES + ("vegan-mmd",):
                t["p_z"] = d.normal("p_z", (raw_x.shape[0], cfg.dim_latent),
                                    self.compute_dtype, raw_x.device)
            if mode in XZ_MODES:
                t["fake_x"], _, _ = networks.generator(cfg, params, t["p_z"])
            if gen and mode in REC_Z_MODES:
                t["rec_z"], _, _ = networks.extractor(
                    cfg, params, t["fake_x"], d, "eps_rec")
        if mode in VEGAN_CODE_MODES:
            t["disc_real"] = networks.discriminator_z(cfg, params, t["p_z"],
                                                      d, "d_real")
            t["disc_fake"] = networks.discriminator_z(cfg, params, q_z, d,
                                                      "d_fake")
        elif mode in XZ_MODES and (gen or not self._fused_gp()):
            disc = self.discriminator(params)
            t["disc_real"] = disc(real_x, q_z)
            t["disc_fake"] = disc(t["fake_x"], t["p_z"])
        return t

    def _rowwise_disc(self) -> bool:
        """True where the joint D has no batch-coupled op (no BN in the
        cifar10, svhn and celeba D stacks; dropout is the identity), so one
        apply over stacked batches is exact per row; the mnist D has
        batch-statistics BN (``gan_inference.py:86-97``)."""
        return self.cfg.dataset in ("cifar10", "svhn", "celeba")

    def _fused_gp(self) -> bool:
        return self.cfg.mode == "wali-gp" and self.cfg.fused_gp \
            and self._rowwise_disc()

    def discriminator(self, params: Params):
        return lambda x, z: networks.discriminator_xz(self.cfg, params, x, z)

    def _rec_penalty(self, t) -> Optional[torch.Tensor]:
        """``gan_inference.py:111-123``."""
        mode, dist = self.cfg.mode, self.cfg.distance_x
        if mode in ("alice-z", "alice", "vegan", "vegan-wgan-gp", "vegan-mmd",
                    "vegan-kl", "vegan-ikl", "vegan-jsd"):
            rec = penalties.distance(t["real_x"], t["rec_x"], dist)
            if mode == "alice":
                rec = rec + penalties.distance(t["p_z"], t["rec_z"], dist)
            return rec
        if mode == "alice-x":
            return penalties.distance(t["p_z"], t["rec_z"], dist)
        return None

    def gradient_penalty(self, params: Params, t: Dict[str, torch.Tensor],
                         alpha: Optional[torch.Tensor] = None,
                         generator=None,
                         draws: Optional[Draws] = None) -> torch.Tensor:
        """The mode's penalty on interpolates: of (x, z) for wali-gp, of z
        for vegan-wgan-gp; ``alpha`` [B, 1] f32."""
        d = draws or self.draws(alpha=alpha, generator=generator)
        b = t["q_z"].shape[0]
        alpha = d.uniform("alpha", (b, 1), t["q_z"].device)
        if self.cfg.mode == "vegan-wgan-gp":
            return penalties.gradient_penalty_z(
                lambda z: networks.discriminator_z(self.cfg, params, z, d,
                                                   "gp_noise"),
                t["q_z"], t["p_z"], alpha, self.cfg.gp_lambda)
        return penalties.gradient_penalty_xz(
            self.discriminator(params), t["real_x"], t["fake_x"], t["q_z"],
            t["p_z"], alpha, self.cfg.gp_lambda)

    def _kl_cost(self, t, rec, d: Draws) -> torch.Tensor:
        """vegan-kl / -ikl / -jsd (``gan_inference.py:159-179``): the prior
        moments are z_samples-shaped, n_coms is the runtime batch."""
        cfg, mode = self.cfg, self.cfg.mode
        # the aggregated posterior couples every row of the batch: gathered
        # over the batch's ranks (identity on one rank)
        q_mean = shard_ctx.gather_batch(t["q_z_mean"])
        q_std = shard_ctx.gather_batch(t["q_z_std"])
        dev = q_mean.device
        shape = (cfg.z_samples, cfg.dim_latent)
        p_mean = torch.zeros(shape, device=dev)
        p_std = torch.ones(shape, device=dev)
        b = q_mean.shape[0]
        if mode in ("vegan-kl", "vegan-jsd"):
            idx = d.randint("mix_idx", b, (cfg.z_samples,), dev)
            eps = d.normal("mix_eps", shape, torch.float32, dev)
        if mode in ("vegan-ikl", "vegan-jsd"):
            z_prior = d.normal("z_prior", shape, torch.float32, dev)
        if mode == "vegan-kl":
            return kl_aggregated.vegan_kl(idx, eps, q_mean, q_std, p_mean,
                                          p_std, rec, cfg.lambda_)
        if mode == "vegan-ikl":
            return kl_aggregated.vegan_ikl(z_prior, q_mean, q_std, p_mean,
                                           p_std, rec, cfg.lambda_)
        return kl_aggregated.vegan_jsd(idx, eps, z_prior, q_mean, q_std,
                                       p_mean, p_std, rec, b, cfg.lambda_)

    def gen_loss(self, params: Params, raw_x: torch.Tensor,
                 p_z: Optional[torch.Tensor] = None, generator=None,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """The G+E player's loss (``gan_inference.py:125-190, 194-200``)."""
        cfg, mode = self.cfg, self.cfg.mode
        d = self.draws(p_z, None, generator, draws)
        t = self._graph(params, raw_x, draws=d)
        rec = self._rec_penalty(t)
        zero = torch.zeros((), device=raw_x.device)
        if mode == "ali":
            g, _ = objs.ali(t["disc_fake"], t["disc_real"])
        elif mode in ("alice", "alice-z", "alice-x"):
            g, _ = objs.alice(t["disc_fake"], t["disc_real"], rec)
        elif mode == "vegan":
            g, _ = objs.vegan(t["disc_fake"], t["disc_real"], rec,
                              cfg.lambda_)
        elif mode == "vegan-wgan-gp":
            g, _ = objs.vegan_wgan_gp(t["disc_fake"], t["disc_real"], rec,
                                      zero, cfg.lambda_)
        elif mode == "wali":
            g, _ = objs.wali(t["disc_fake"], t["disc_real"])
        elif mode == "wali-gp":
            g, _ = objs.wali_gp(t["disc_fake"], t["disc_real"], zero)
        elif mode == "vegan-mmd":
            g = mmd.vegan_mmd(shard_ctx.gather_batch(t["q_z"]),
                              shard_ctx.gather_batch(t["p_z"]), rec,
                              cfg.lambda_)
        elif mode in KL_MODES:
            g = self._kl_cost(t, rec, d)
        elif mode == "vae":
            g = kl.vae(t["real_x"], t["rec_x"],
                       torch.full_like(t["rec_x"], cfg.std),
                       t["q_z_mean"], t["q_z_std"],
                       torch.zeros_like(t["q_z_mean"]),
                       torch.ones_like(t["q_z_std"]))
        else:
            raise ValueError(f"unknown gan_inference mode {mode!r}")
        aux = {"gen_cost": g}
        if rec is not None:
            aux["rec_cost"] = rec
        return g, aux

    def disc_loss(self, params: Params, raw_x: torch.Tensor,
                  p_z: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None, generator=None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict]:
        """The D player's loss (``gan_inference.py:125-190, 202-206``)."""
        cfg, mode = self.cfg, self.cfg.mode
        if not cfg.has_discriminator:
            raise ValueError(f"mode {mode} has no discriminator")
        d = self.draws(p_z, alpha, generator, draws)
        t = self._graph(params, raw_x, players_grad=False, draws=d)
        aux: Dict[str, torch.Tensor] = {}
        if mode in ("ali", "alice", "alice-z", "alice-x"):
            _, cost = objs.ali(t["disc_fake"], t["disc_real"])
        elif mode == "vegan":
            _, cost = objs.vegan(t["disc_fake"], t["disc_real"], 0.0,
                                 cfg.lambda_)
        elif mode == "vegan-wgan-gp":
            aux["gp"] = self.gradient_penalty(params, t, draws=d)
            _, cost = objs.vegan_wgan_gp(t["disc_fake"], t["disc_real"], 0.0,
                                         aux["gp"], cfg.lambda_)
        elif mode == "wali":
            _, cost = objs.wali(t["disc_fake"], t["disc_real"])
        elif self._fused_gp():
            alpha = d.uniform("alpha", (raw_x.shape[0], 1), raw_x.device)
            t["disc_real"], t["disc_fake"], aux["gp"] = \
                penalties.wali_gp_fused(
                    self.discriminator(params), t["real_x"], t["fake_x"],
                    t["q_z"], t["p_z"], alpha, cfg.gp_lambda)
            _, cost = objs.wali_gp(t["disc_fake"], t["disc_real"], aux["gp"])
        else:  # wali-gp
            aux["gp"] = self.gradient_penalty(params, t, draws=d)
            _, cost = objs.wali_gp(t["disc_fake"], t["disc_real"], aux["gp"])
        aux["disc_cost"] = cost
        return cost, aux

    # -- optimizer presets ----------------------------------------------------

    def opt_specs(self) -> Tuple[OptSpec, Optional[OptSpec]]:
        """(G+E player's, D player's) optimizer (``gan_inference.py:
        242-255``); None for a mode without a discriminator."""
        cfg, mode = self.cfg, self.cfg.mode
        if mode in ("wali", "wali-gp"):
            spec = optimizer_for(mode.replace("-", "_"))
            return spec, spec
        gen = optimizer_for(mode, lr=cfg.lr, beta1=cfg.beta1)
        if not cfg.has_discriminator:
            return gen, None
        if mode == "ali":  # ali passes beta2 (gan_inference_mnist.py:286)
            gen = optimizer_for(mode, lr=cfg.lr, beta1=cfg.beta1,
                                beta2=cfg.beta2)
        return gen, gen
