"""Model family 2, GMGAN (``graphical_gan_tpu/models/gmgan.py``): the
family-1 chain with a discrete mixture component k. The prior draws k
uniformly and maps it through the mixture means ``Generator.Hyper.Mu``
[n_coms, z]: ``p_z = k @ Mu + eps``. The posterior q(k|z) scores a code by
its squared distances to the same means plus the log prior, and draws k
per ``MODE_K``:

- ``CONCRETE``: softmax((logits + g) / temp), g Gumbel;
- ``STRAIGHT_THROUGHT_CONCRETE``: the hard one-hot of that sample, with
  the soft sample's gradient, ``(hard - soft).detach() + soft``;
- ``STRAIGHT_THROUGHT``: ``(hard - logits).detach() + logits``;
- ``REINFORCE``: the argmax one-hot, and the generator cost gains
  ``mean((f_k - cv).detach() * log max q(k|x))`` (``objectives/
  discrete.py``). The reference adds the per-example surrogate vector to
  a scalar cost, which TF sums, so the rest of its generator gradient is
  scaled by the batch size; the JAX package adds the mean, and so does the
  port.

``Mu`` is named ``Generator.*`` so the generator player trains it, though
the posterior reads it too. The discriminators, per mode
(``gmgan_inference_mnist.py:247-330``):

- local_ep, local_epce: [D(z, k) on the codes, D(x, z) on the data];
- ali, alice: one joint D(x, z, k);
- vegan: D(z, k) alone.

D(z, k) is an MLP of 512 units (``Discriminator.Hyper*``); the data-side Ds
share a trunk of 5x5 stride-2 convs with the leaky ReLU in K1's epilogue
and no BN (prefix ``Discriminator.`` for D(x, z), ``Discriminator.x`` for
D(x, z, k); four convs of ``dim_d`` on celeba). Dropout is the identity.

As in family 1 (``models/gan_inference.py``) the losses are functions of a
``{name: tensor}`` params dict with the JAX names and TF layouts, each
computes only what its cost reads (no ``E(G(p_z))``; ``rec_x`` only for
the modes with a reconstruction penalty, in ``gen_loss``), and
``disc_loss`` runs E and G under ``torch.no_grad()``. Random draws come
from a :class:`~models.common.Draws` by name. The JAX graph draws, in this
order: ``dequant`` (celeba's input noise, [B, D] f32); the uniform
``gumbel_q`` [B, n_coms] f32 of q(k|x)'s Gumbel noise (CONCRETE and
STRAIGHT_THROUGHT_CONCRETE); ``hyper_p_z`` [B, z] f32, the prior's eps;
``prior_idx`` [B] int64, the prior's component; and ``gumbel_rec``, the
Gumbel noise of q(k|E(G(p_z))), which no cost reads: it takes a key of
JAX's stream but the port never draws it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core.config import (
    GMGAN_MODES, MODE_KS, GMGanConfig)
from graphical_gan_tpu_torch.models import networks
from graphical_gan_tpu_torch.models.common import Draws, normalize_input
from graphical_gan_tpu_torch.models.gan_inference import (
    _conv, _linear, encoder_generator_specs)
from graphical_gan_tpu_torch.core import shard_ctx
from graphical_gan_tpu_torch.objectives import discrete
from graphical_gan_tpu_torch.objectives import gan_inference as objs
from graphical_gan_tpu_torch.objectives import penalties
from graphical_gan_tpu_torch.objectives.common import OptSpec, optimizer_for
from graphical_gan_tpu_torch.ops import (
    conv2d, dropout, initializers as inits, leaky_relu, linear,
    unflatten_image)
from graphical_gan_tpu_torch.ops.activations import sample_gumbel

Params = Dict[str, torch.Tensor]

MU = "Generator.Hyper.Mu"
# modes whose generator cost has a reconstruction penalty
REC_MODES = ("alice", "local_epce", "vegan")
LIST_MODES = ("local_ep", "local_epce")


class GMGanModel:
    GEN_PLAYER = ("Generator", "Extractor")
    DISC_PLAYER = ("Discriminator",)
    #: every draw is made by G and D updates alike
    DISC_ONLY_DRAWS = ()

    def __init__(self, cfg: GMGanConfig):
        if cfg.dataset not in ("mnist", "cifar10", "svhn", "celeba"):
            raise ValueError(f"unknown gmgan dataset {cfg.dataset!r}")
        if cfg.mode not in GMGAN_MODES:
            raise ValueError(f"unknown gmgan mode {cfg.mode!r}")
        if cfg.mode_k not in MODE_KS:
            raise ValueError(f"unknown MODE_K {cfg.mode_k!r}")
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- parameters ---------------------------------------------------------

    def _trunk_widths(self):
        cfg = self.cfg
        ch = cfg.data.channels
        if cfg.dataset == "celeba":
            dim = cfg.dim_d or cfg.dim
            return [ch, dim, 2 * dim, 4 * dim, 8 * dim], 4 * 4 * 8 * dim
        dim = cfg.dim
        return [ch, dim, 2 * dim, 4 * dim], 4 * 4 * 4 * dim

    def param_specs(self):
        """Every parameter the JAX ``init`` makes, by name."""
        cfg = self.cfg
        dl, nc = cfg.dim_latent, cfg.n_coms
        s = encoder_generator_specs(cfg)
        s[MU] = ("normal", (nc, dl), ())
        if cfg.mode in ("vegan",) + LIST_MODES:
            _linear(s, "Discriminator.HyperInput", dl + nc, 512)
            _linear(s, "Discriminator.Hyper2", 512, 512)
            _linear(s, "Discriminator.Hyper3", 512, 512)
            _linear(s, "Discriminator.HyperOutput", 512, 1)
        if cfg.mode == "vegan":
            return s
        widths, feat = self._trunk_widths()
        prefix = "Discriminator." if cfg.mode in LIST_MODES \
            else "Discriminator.x"
        for i in range(len(widths) - 1):
            _conv(s, f"{prefix}{i + 1}", widths[i], widths[i + 1])
        if cfg.mode in LIST_MODES:
            _linear(s, "Discriminator.z1", dl, 512)
            _linear(s, "Discriminator.zx1", feat + 512, 512)
        else:
            _linear(s, "Discriminator.zk1", dl + nc, 512)
            _linear(s, "Discriminator.zkx1", feat + 512, 512)
        _linear(s, "Discriminator.Output", 512, 1)
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> Params:
        """Fresh parameters with the JAX names, shapes and init statistics,
        drawn from a ``torch.Generator`` seeded with ``seed`` on
        ``device``."""
        return inits.init_params(self.param_specs(), seed, device)

    # -- mixture components ---------------------------------------------------

    def hyper_generator(self, params: Params, k: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
        """``p_z = k @ Mu + eps`` in f32 (``gmgan_inference_mnist.py:
        142-145``); a plain product, as JAX computes it outside any Pallas
        kernel."""
        # EP: the rank's block of components times its means, summed over
        # the expert group (identity on one rank)
        k = shard_ctx.constrain_components(k.float())
        return shard_ctx.sum_components(
            torch.matmul(k, params[MU].float())) + noise.float()

    def component_logits(self, params: Params, z: torch.Tensor
                         ) -> torch.Tensor:
        """q(k|z)'s logits [B, n_coms], f32: -|z - Mu_k|^2 / 2 + log(1/K)
        (``:148-165``)."""
        zf = shard_ctx.to_components(z.float())  # EP: the rank's means
        sq = (zf[:, None, :] - params[MU].float()[None]).square()
        return -0.5 * sq.sum(dim=-1) + math.log(1.0 / self.cfg.n_coms)

    def posterior_sample(self, logits: torch.Tensor, draws: Draws,
                         name: str) -> torch.Tensor:
        """The k sample of ``MODE_K`` from the logits; the Gumbel modes
        draw their uniform noise under ``name``."""
        cfg = self.cfg
        mk = cfg.mode_k
        if mk in ("REINFORCE", "STRAIGHT_THROUGHT"):
            hard = shard_ctx.component_argmax_one_hot(logits, cfg.n_coms)
            if mk == "REINFORCE":
                return hard
            return (hard - logits).detach() + logits
        # drawn whole, the rank's block of components kept (EP)
        u = shard_ctx.constrain_components(draws.uniform(
            name, (logits.shape[0], cfg.n_coms), logits.device))
        k = shard_ctx.component_softmax((logits + sample_gumbel(u))
                                        / cfg.temp)
        if mk == "CONCRETE":
            return k
        hard = shard_ctx.component_argmax_one_hot(k, cfg.n_coms)
        return (hard - k).detach() + k

    # -- discriminators -------------------------------------------------------

    def _whole_k(self, k: torch.Tensor) -> torch.Tensor:
        """k over every component: under EP a block of them is gathered."""
        if k.shape[-1] == self.cfg.n_coms:
            return k
        return shard_ctx.gather_components(k)

    def hyper_discriminator(self, params: Params, z: torch.Tensor,
                            k: torch.Tensor) -> torch.Tensor:
        """D(z, k): an MLP of 512 units (``gmgan_inference_mnist.py:
        249-265``); [B] scores."""
        dr = self.cfg.dropout_rate
        h = torch.cat([z, self._whole_k(k).to(z.dtype)], dim=1)
        for name in ("HyperInput", "Hyper2", "Hyper3"):
            h = dropout(leaky_relu(linear(params, f"Discriminator.{name}",
                                          h)), dr)
        return linear(params, "Discriminator.HyperOutput", h).reshape(-1)

    def _conv_trunk(self, params: Params, x_flat: torch.Tensor,
                    prefix: str) -> torch.Tensor:
        """The data-side Ds' trunk: k5 s2 convs with the leaky ReLU in K1's
        epilogue, no BN; the flattened NHWC feature."""
        cfg = self.cfg
        hgt, wdt = cfg.data.image_hw
        widths, feat = self._trunk_widths()
        h = unflatten_image(x_flat, cfg.data.channels, hgt, wdt)
        for i in range(len(widths) - 1):
            h = dropout(conv2d(params, f"{prefix}{i + 1}", h, stride=2,
                               act="leaky_relu"), cfg.dropout_rate)
        return h.reshape(-1, feat)

    def discriminator_xz(self, params: Params, x_flat: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
        """local_ep's data-layer D(x, z) (``:267-295``)."""
        dr = self.cfg.dropout_rate
        h = self._conv_trunk(params, x_flat, "Discriminator.")
        hz = dropout(leaky_relu(linear(params, "Discriminator.z1", z)), dr)
        h = torch.cat([h, hz], dim=1)
        h = dropout(leaky_relu(linear(params, "Discriminator.zx1", h)), dr)
        return linear(params, "Discriminator.Output", h).reshape(-1)

    def discriminator_xzk(self, params: Params, x_flat: torch.Tensor,
                          z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """ali/alice's joint D(x, z, k) (``:301-330``)."""
        dr = self.cfg.dropout_rate
        h = self._conv_trunk(params, x_flat, "Discriminator.x")
        hzk = torch.cat([z, self._whole_k(k).to(z.dtype)], dim=1)
        hzk = dropout(leaky_relu(linear(params, "Discriminator.zk1", hzk)),
                      dr)
        h = torch.cat([h, hzk], dim=1)
        h = dropout(leaky_relu(linear(params, "Discriminator.zkx1", h)), dr)
        return linear(params, "Discriminator.Output", h).reshape(-1)

    # -- graph ----------------------------------------------------------------

    def normalize(self, raw: torch.Tensor, draws: Optional[Draws] = None
                  ) -> torch.Tensor:
        return normalize_input(self.cfg, raw, self.compute_dtype, draws)

    def _graph(self, params: Params, raw_x: torch.Tensor, d: Draws,
               gen: bool) -> Dict:
        """The tensors the mode's costs read (``gmgan_inference_mnist.py:
        335-372``): ``gen`` True builds the G+E player's graph, False the D
        player's, with E, G and the posterior under ``no_grad``."""
        cfg, mode = self.cfg, self.cfg.mode
        b, dev = raw_x.shape[0], raw_x.device
        t: Dict = {}
        with torch.set_grad_enabled(gen and torch.is_grad_enabled()):
            real_x = self.normalize(raw_x, d)
            q_z, _, _ = networks.extractor(cfg, params, real_x, d)
            logits = self.component_logits(params, q_z)
            q_k = self.posterior_sample(logits, d, "gumbel_q")
            t.update(real_x=real_x, q_z=q_z, q_k_logits=logits, q_k=q_k)
            if gen and mode in REC_MODES:
                t["rec_x"], _, _ = networks.generator(cfg, params, q_z)
            eps = d.normal("hyper_p_z", (b, cfg.dim_latent), torch.float32,
                           dev)
            idx = d.randint("prior_idx", cfg.n_coms, (b,), dev)
            p_k = F.one_hot(idx, cfg.n_coms).float()
            p_z = self.hyper_generator(params, p_k, eps).to(
                self.compute_dtype)
            t.update(hyper_p_k=p_k, p_z=p_z)
            if mode != "vegan":
                t["fake_x"], _, _ = networks.generator(cfg, params, p_z)
        if mode == "vegan":
            t["disc_fake"] = self.hyper_discriminator(params, p_z, p_k)
            t["disc_real"] = self.hyper_discriminator(params, q_z, q_k)
        elif mode in LIST_MODES:
            t["disc_fake_list"] = [
                self.hyper_discriminator(params, p_z, p_k),
                self.discriminator_xz(params, t["fake_x"], p_z)]
            t["disc_real_list"] = [
                self.hyper_discriminator(params, q_z, q_k),
                self.discriminator_xz(params, real_x, q_z)]
        else:
            t["disc_real"] = self.discriminator_xzk(params, real_x, q_z, q_k)
            t["disc_fake"] = self.discriminator_xzk(params, t["fake_x"], p_z,
                                                    p_k)
        return t

    def _score_fn(self, t) -> Optional[torch.Tensor]:
        """The REINFORCE surrogate's mean (``:355-372``)."""
        if self.cfg.mode_k != "REINFORCE":
            return None
        p_max = shard_ctx.gather_components(shard_ctx.component_softmax(
            t["q_k_logits"])).max(dim=1).values
        f_k = t["disc_real_list"][0] if "disc_real_list" in t \
            else t["disc_real"]
        return discrete.score_function(f_k, p_max,
                                       self.cfg.control_variate).mean()

    def _costs(self, t, s_f=None, rec=None):
        """(gen cost, disc cost) of the mode (``gmgan.py:236-261``)."""
        cfg, mode = self.cfg, self.cfg.mode
        zero = torch.zeros((), device=t["q_z"].device)
        if mode == "ali":
            return objs.ali(t["disc_fake"], t["disc_real"], s_f)
        if mode == "alice":
            return objs.alice(t["disc_fake"], t["disc_real"],
                              zero if rec is None else rec, s_f)
        if mode == "local_ep":
            return objs.local_ep(t["disc_fake_list"], t["disc_real_list"],
                                 s_f)
        if mode == "local_epce":
            return objs.local_epce(t["disc_fake_list"], t["disc_real_list"],
                                   zero if rec is None else rec, s_f)
        return objs.vegan(t["disc_fake"], t["disc_real"],
                          zero if rec is None else rec, cfg.lambda_, s_f)

    def gen_loss(self, params: Params, raw_x: torch.Tensor, generator=None,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """The G+E player's loss; aux ``gen_cost`` and, for the modes with
        a reconstruction penalty, ``rec_cost``."""
        t = self._graph(params, raw_x, Draws(draws, generator), gen=True)
        rec = None
        if self.cfg.mode in REC_MODES:
            rec = penalties.distance(t["real_x"], t["rec_x"],
                                     self.cfg.distance_x)
        g, _ = self._costs(t, self._score_fn(t), rec)
        aux = {"gen_cost": g}
        if rec is not None:
            aux["rec_cost"] = rec
        return g, aux

    def disc_loss(self, params: Params, raw_x: torch.Tensor, generator=None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict]:
        """The D player's loss."""
        t = self._graph(params, raw_x, Draws(draws, generator), gen=False)
        _, d = self._costs(t)
        return d, {"disc_cost": d}

    # -- serving and eval forwards -------------------------------------------

    def sample(self, params: Params, k_onehot: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """G of the prior's codes for given components and eps (the
        per-component grids, ``:405-419``)."""
        z = self.hyper_generator(params, k_onehot, noise).to(
            self.compute_dtype)
        x, _, _ = networks.generator(self.cfg, params, z)
        return x

    def encode(self, params: Params, raw_x: torch.Tensor, generator=None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """q(z|x) codes (what the TSNE eval embeds, ``:534-545``)."""
        d = Draws(draws, generator)
        q_z, _, _ = networks.extractor(self.cfg, params,
                                       self.normalize(raw_x, d), d)
        return q_z

    def reconstruct(self, params: Params, raw_x: torch.Tensor,
                    generator=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        q_z = self.encode(params, raw_x, generator, draws)
        x, _, _ = networks.generator(self.cfg, params, q_z)
        return x

    def cluster_probs(self, params: Params, raw_x: torch.Tensor,
                      generator=None,
                      draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> torch.Tensor:
        """q(k|x) [B, n_coms], f32: the clustering-accuracy eval's
        posteriors (``:513-531``)."""
        q_z = self.encode(params, raw_x, generator, draws)
        return torch.softmax(self.component_logits(params, q_z), dim=-1)

    # -- optimizer presets ----------------------------------------------------

    def opt_specs(self) -> Tuple[OptSpec, OptSpec]:
        """Adam(lr, beta1[, beta2]) for both players; beta2 is passed only
        for ali and local_ep, as the JAX model passes it."""
        cfg = self.cfg
        spec = optimizer_for(cfg.mode, lr=cfg.lr, beta1=cfg.beta1,
                             beta2=cfg.beta2 if cfg.mode in
                             ("ali", "local_ep") else None)
        return spec, spec
