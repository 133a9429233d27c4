"""Model family 3, SSGAN (``graphical_gan_tpu/models/ssgan.py``): a
state-space GAN over videos, moving-MNIST (LEN 16, conditional on 10
classes, 1 channel, ``res``) and 3D chairs (LEN 31, unconditional, 3
channels, ``res_w``).

The reference (``ssgan_inference_moving_mnist.py``):

- **Latent chains.** The prior's motion chain is z_{t+1} = Op(z_t, eps)
  (``dynamic_generator``, ``:134-141``), one shared parameter set
  ``Generator.Dynamic`` and, as in the reference, ONE eps drawn per call
  and reused at every step. The posterior refines per-frame pre-codes per
  ``pos_mode`` (``dynamic_extractor``, ``:143-168``): ``naive_mean_field``
  keeps them, ``inverse`` runs the backward chain z_t = CO(z_{t+1}, pre_t)
  from the last frame down, ``forward_inverse`` the forward chain
  z_{t+1} = CO(z_t, pre_{t+1}), and ``gsp`` the forward chain over the
  backward chain's output. JAX runs the chains as ``lax.scan``s; here they
  are Python loops over LEN.
- **Frame networks.** G tiles the global code z_g over time and runs a
  4-deconv DCGAN at the folded batch B·LEN; E is a per-frame conv stack to
  the motion pre-codes; the global extractor reads the whole video as one
  (C·LEN)-channel image.
- **Discriminators.** ``local_ep`` / ``local_epce-z``: LEN-1 pair Ds over
  (z_t, z_{t+1}) (one weight-shared MLP over every pair), a D on z_g and a
  per-frame joint D(x, z_g, z_l, y), weighted by ``cfg.ratio``
  (``weighted_local_epce``). ``ali`` / ``alice-z``: one video D per
  ``ali_mode``: ``concat_x`` (frames as channels), ``concat_z`` (per-frame
  convs, then a VALID 4x4 conv to one z_g-sized vector per frame) or
  ``3dcnn`` (four Conv3D layers over NDHWC).

Under SP (``parallel/sequence.py``) the frame networks take the rank's
block of each video's frames at JAX's fold points (``core/shard_ctx.py:
constrain_frames``: the folded frame codes, the frame batches of E, the
frame D and concat_z's D) and gather their outputs over ``seq`` again
(``gather_frames``) for the latent chains and the costs.

Convs go through ``ops.conv2d`` (the K1 kernel), with the leaky ReLU in
K1's epilogue exactly where JAX fuses it (``Extractor.1``,
``Extractor.G.1``, ``Discriminator.1``); BN (``cfg.bn``, off by default)
through ``models.common.bn_act`` (K2a-d), including the dense
``Generator.BN1`` over ``axes=[0]`` and the 3dcnn's 5-D BNs. The deconvs
and the conv3d have no Pallas kernel in JAX and run on the library
(``ops/conv.py``). Dropout is the identity.

The losses are functions of a ``{name: tensor}`` params dict with the JAX
names and shapes. Each computes what its cost reads: ``rec_x`` only in
``gen_loss`` of the modes with a reconstruction penalty, and
``disc_loss`` runs E and G under ``torch.no_grad()``. Random draws come
from a :class:`~models.common.Draws` by name, in the JAX graph's order:
``p_z_l_0`` [B, dl] (compute dtype), ``epsilon`` [B, dl] (the prior
chain's one eps, compute dtype), ``p_z_g`` [B, dlg] (compute dtype) and,
conditional only, ``p_y`` [B] int64 (the prior's class); ``sample`` draws
``epsilon`` only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from graphical_gan_tpu_torch.core import shard_ctx
from graphical_gan_tpu_torch.core.config import (
    ALI_MODES, POS_MODES, SSGAN_MODES, SSGanConfig)
from graphical_gan_tpu_torch.models.common import (
    Draws, bn_act, normalize_input)
from graphical_gan_tpu_torch.models.gan_inference import (
    _bn, _conv, _deconv, _linear)
from graphical_gan_tpu_torch.objectives import gan_inference as objs
from graphical_gan_tpu_torch.objectives import penalties
from graphical_gan_tpu_torch.objectives.common import OptSpec, optimizer_for
from graphical_gan_tpu_torch.ops import (
    conv2d, conv3d, deconv2d, dropout, flatten_image, initializers as inits,
    leaky_relu, linear, unflatten_image)

Params = Dict[str, torch.Tensor]

LIST_MODES = ("local_ep", "local_epce-z")
REC_MODES = ("local_epce-z", "alice-z")


def _conv3d(specs, name, k_len, cin, cout, k, stride, stride_len):
    specs[name + ".Filters"] = ("conv3d", (k_len, k, k, cin, cout),
                                (cin, cout, k, k_len, stride, stride_len))
    specs[name + ".Biases"] = ("zeros", (cout,), ())


class SSGanModel:
    GEN_PLAYER = ("Generator", "Extractor")
    DISC_PLAYER = ("Discriminator",)
    #: every draw is made by G and D updates alike
    DISC_ONLY_DRAWS = ()

    def __init__(self, cfg: SSGanConfig):
        if cfg.mode not in SSGAN_MODES:
            raise ValueError(f"unknown ssgan mode {cfg.mode!r}")
        if cfg.pos_mode not in POS_MODES:
            raise ValueError(f"unknown pos_mode {cfg.pos_mode!r}")
        if cfg.ali_mode not in ALI_MODES:
            raise ValueError(f"unknown ali_mode {cfg.ali_mode!r}")
        if cfg.op_dyn_mode not in ("res", "res_w"):
            raise ValueError(f"unknown op_dyn_mode {cfg.op_dyn_mode!r}")
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    # -- parameters ---------------------------------------------------------

    def _operator_specs(self, s, name, din):
        cfg = self.cfg
        _linear(s, name + ".Input", din, cfg.dim_op)
        _linear(s, name + ".1", cfg.dim_op, cfg.dim_op)
        _linear(s, name + ".Output", cfg.dim_op, cfg.dim_latent_l)
        if cfg.op_dyn_mode == "res_w":
            _linear(s, name + ".ZW", cfg.dim_latent_l, cfg.dim_latent_l)

    def _conv_stack_specs(self, s, prefix, cin):
        """Four k5 s2 convs (cin -> dim -> ... -> 8 dim), BN on 2-4."""
        dim = self.cfg.dim
        widths = [cin, dim, 2 * dim, 4 * dim, 8 * dim]
        for i in range(4):
            _conv(s, f"{prefix}{i + 1}", widths[i], widths[i + 1])
            if i and self.cfg.bn:
                _bn(s, f"{prefix}BN{i + 1}", widths[i + 1])

    def _mlp_specs(self, s, prefix, din, names):
        _linear(s, f"{prefix}{names[0]}", din, 512)
        _linear(s, f"{prefix}{names[1]}", 512, 512)
        _linear(s, f"{prefix}{names[2]}", 512, 512)
        _linear(s, f"{prefix}{names[3]}", 512, 1)

    def _3dcnn_depths(self) -> List[int]:
        """The temporal strides of the 3dcnn D's four Conv3Ds."""
        sl = 1 if self.cfg.seq_len == 4 else 2
        return [2, sl, 2, sl]

    def param_specs(self):
        """Every parameter the JAX ``init`` makes, by name."""
        cfg = self.cfg
        dim, dl, dlg = cfg.dim, cfg.dim_latent_l, cfg.dim_latent_g
        nc = cfg.n_classes if cfg.conditional else 0
        ch, L = cfg.channels, cfg.seq_len
        feat = 4 * 4 * 8 * dim
        s: Dict = {}
        self._conv_stack_specs(s, "Extractor.", ch)
        _linear(s, "Extractor.Output", feat + nc, dl)
        self._conv_stack_specs(s, "Extractor.G.", ch * L)
        _linear(s, "Extractor.G.Output", feat + nc, dlg)
        if cfg.pos_mode in ("inverse", "gsp"):
            self._operator_specs(s, "Extractor.Dynamic.Backward", 2 * dl)
        if cfg.pos_mode in ("forward_inverse", "gsp"):
            self._operator_specs(s, "Extractor.Dynamic.Forward", 2 * dl)
        _linear(s, "Generator.Input", dlg + dl + nc, feat)
        if cfg.bn:
            _bn(s, "Generator.BN1", feat)
        widths = [8 * dim, 4 * dim, 2 * dim, dim]
        for i in range(3):
            _deconv(s, f"Generator.{i + 2}", widths[i], widths[i + 1])
            if cfg.bn:
                _bn(s, f"Generator.BN{i + 2}", widths[i + 1])
        _deconv(s, "Generator.5", dim, ch)
        self._operator_specs(s, "Generator.Dynamic", dl + cfg.dim_latent_t)
        if cfg.mode in LIST_MODES:
            self._mlp_specs(s, "Discriminator.Dynamic.", 2 * dl,
                            ("Input", "2", "3", "Output"))
            self._mlp_specs(s, "Discriminator.ZG.", dlg,
                            ("Input", "2", "3", "Output"))
            self._conv_stack_specs(s, "Discriminator.", ch)
            _linear(s, "Discriminator.z1", dlg + dl + nc, 512)
            _linear(s, "Discriminator.zx1", feat + 512 + nc, 512)
            _linear(s, "Discriminator.Output", 512, 1)
            return s
        zdim = dlg + L * dl + nc
        extra = 0
        if cfg.ali_mode == "concat_x":
            self._conv_stack_specs(s, "Discriminator.", ch * L)
        elif cfg.ali_mode == "concat_z":
            self._conv_stack_specs(s, "Discriminator.", ch)
            _conv(s, "Discriminator.5", 8 * dim, dlg, k=4, stride=1)
            feat = L * dlg
            extra = nc
        else:
            widths = [ch, dim, 2 * dim, 4 * dim, 8 * dim]
            depth = L
            for i, sl in enumerate(self._3dcnn_depths()):
                _conv3d(s, f"Discriminator.{i + 1}", 4, widths[i],
                        widths[i + 1], 4, 2, sl)
                if i and cfg.bn:
                    _bn(s, f"Discriminator.BN{i + 1}", widths[i + 1])
                depth = -(-depth // sl)
            feat = depth * 4 * 4 * 8 * dim
        _linear(s, "Discriminator.z1", zdim, 512)
        _linear(s, "Discriminator.zx1", feat + 512 + extra, 512)
        _linear(s, "Discriminator.Output", 512, 1)
        return s

    def init(self, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> Params:
        """Fresh parameters with the JAX names, shapes and init statistics,
        drawn from a ``torch.Generator`` seeded with ``seed`` on
        ``device``."""
        return inits.init_params(self.param_specs(), seed, device)

    # -- latent-chain operators ---------------------------------------------

    def _operator(self, params: Params, name: str, z: torch.Tensor,
                  other: torch.Tensor) -> torch.Tensor:
        """The 3-layer MLP over concat(z, other) with its residual ('res')
        or learned skip ('res_w') on z: ImplicitOperator (other = eps,
        ``:98-114``) and ConcatOperator (other = the next pre-code,
        ``:116-132``) alike."""
        h = torch.cat([z, other], dim=1)
        h = leaky_relu(linear(params, name + ".Input", h))
        h = leaky_relu(linear(params, name + ".1", h))
        out = linear(params, name + ".Output", h)
        if self.cfg.op_dyn_mode == "res":
            return z + out
        return out + linear(params, name + ".ZW", z)

    def dynamic_generator(self, params: Params, z_l_0: torch.Tensor,
                          d: Draws) -> torch.Tensor:
        """The prior's chain, [B, LEN, dl]; one ``epsilon`` for every
        step."""
        cfg = self.cfg
        eps = d.normal("epsilon", (z_l_0.shape[0], cfg.dim_latent_t),
                       z_l_0.dtype, z_l_0.device)
        chain = [z_l_0]
        for _ in range(cfg.seq_len - 1):
            chain.append(self._operator(params, "Generator.Dynamic",
                                        chain[-1], eps))
        return torch.stack(chain, dim=1)

    def dynamic_extractor(self, params: Params, z_l_pre: torch.Tensor
                          ) -> torch.Tensor:
        """The posterior chain per ``pos_mode``, [B, LEN, dl]."""
        mode = self.cfg.pos_mode
        if mode == "naive_mean_field":
            return z_l_pre
        pre = list(z_l_pre.unbind(dim=1))

        def backward_chain(pre):
            name = "Extractor.Dynamic.Backward"
            out = [pre[-1]]
            for t in range(len(pre) - 2, -1, -1):
                out.append(self._operator(params, name, out[-1], pre[t]))
            return out[::-1]

        def forward_chain(pre):
            name = "Extractor.Dynamic.Forward"
            out = [pre[0]]
            for t in range(1, len(pre)):
                out.append(self._operator(params, name, out[-1], pre[t]))
            return out

        if mode == "inverse":
            out = backward_chain(pre)
        elif mode == "forward_inverse":
            out = forward_chain(pre)
        else:
            out = forward_chain(backward_chain(pre))
        return torch.stack(out, dim=1)

    # -- frame networks ------------------------------------------------------

    def _tiled(self, v: torch.Tensor, dtype) -> torch.Tensor:
        """[B, F] -> [B·LEN, F]: one row per frame."""
        return v.to(dtype).repeat_interleave(self.cfg.seq_len, dim=0)

    def _frame_codes(self, z_g, z_l, labels) -> torch.Tensor:
        """[B·LEN, dlg + dl (+ n_classes)]: z_g tiled over time, the frame's
        motion code and, conditional, the label."""
        cfg = self.cfg
        parts = [self._tiled(z_g, z_g.dtype),
                 z_l.reshape(-1, cfg.dim_latent_l).to(z_g.dtype)]
        if cfg.conditional:
            parts.append(self._tiled(labels, z_g.dtype))
        # SP fold point (JAX ssgan.py:205, 291): the rank's frames
        return shard_ctx.constrain_frames(torch.cat(parts, dim=1),
                                          cfg.seq_len)

    def _frame_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The folded frames of a video batch for a frame network: SP's
        fold point (JAX ssgan.py:226, 279, 383), the rank's frames."""
        return shard_ctx.constrain_frames(self._frames(x), self.cfg.seq_len)

    def _frame_labels(self, labels: torch.Tensor, dtype) -> torch.Tensor:
        return shard_ctx.constrain_frames(self._tiled(labels, dtype),
                                          self.cfg.seq_len)

    def _conv_stack(self, params: Params, prefix: str, h: torch.Tensor
                    ) -> torch.Tensor:
        """k5 s2 convs, the first with the leaky ReLU in K1's epilogue,
        the others followed by BN + leaky (or the leaky alone); the
        flattened NHWC feature."""
        cfg = self.cfg
        h = dropout(conv2d(params, f"{prefix}1", h, stride=2,
                           act="leaky_relu"), cfg.dropout_rate)
        for i in range(2, 5):
            h = conv2d(params, f"{prefix}{i}", h, stride=2)
            h = dropout(bn_act(cfg.bn, params, f"{prefix}BN{i}", h,
                               "leaky_relu"), cfg.dropout_rate)
        return h

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        """[B, LEN, C·H·W] -> [B·LEN, H, W, C]."""
        cfg = self.cfg
        hgt, wdt = cfg.image_hw
        return unflatten_image(x.reshape(-1, cfg.output_dim), cfg.channels,
                               hgt, wdt)

    def _video_image(self, x: torch.Tensor) -> torch.Tensor:
        """[B, LEN, C·H·W] -> [B, H, W, LEN·C]: the whole video as one
        image with frames as channels."""
        cfg = self.cfg
        hgt, wdt = cfg.image_hw
        cl = cfg.channels * cfg.seq_len
        return unflatten_image(x.reshape(x.shape[0], -1), cl, hgt, wdt)

    def frame_generator(self, params: Params, z_g: torch.Tensor,
                        z_l: torch.Tensor, labels: Optional[torch.Tensor]
                        ) -> torch.Tensor:
        """``:170-205``; [B, LEN, C·H·W] in tanh range."""
        cfg = self.cfg
        b = z_g.shape[0]
        dim = cfg.dim
        h = linear(params, "Generator.Input",
                   self._frame_codes(z_g, z_l, labels))
        h = bn_act(cfg.bn, params, "Generator.BN1", h, "relu", axes=[0])
        h = h.reshape(-1, 4, 4, 8 * dim)
        for i in range(2, 5):
            h = deconv2d(params, f"Generator.{i}", h)
            h = bn_act(cfg.bn, params, f"Generator.BN{i}", h, "relu")
        h = torch.tanh(deconv2d(params, "Generator.5", h))
        h = shard_ctx.gather_frames(flatten_image(h), cfg.seq_len)
        return h.reshape(b, cfg.seq_len, cfg.output_dim)

    def frame_extractor(self, params: Params, x: torch.Tensor,
                        labels: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-frame conv stack -> the motion pre-codes [B, LEN, dl]
        (``:207-235``)."""
        cfg = self.cfg
        h = self._conv_stack(params, "Extractor.", self._frame_batch(x))
        h = h.reshape(h.shape[0], -1)
        if cfg.conditional:
            h = torch.cat([h, self._frame_labels(labels, h.dtype)], dim=1)
        out = shard_ctx.gather_frames(linear(params, "Extractor.Output", h),
                                      cfg.seq_len)
        return out.reshape(x.shape[0], cfg.seq_len, cfg.dim_latent_l)

    def g_extractor(self, params: Params, x: torch.Tensor,
                    labels: Optional[torch.Tensor]) -> torch.Tensor:
        """The video as a (C·LEN)-channel image -> z_g (``:237-262``)."""
        cfg = self.cfg
        h = self._conv_stack(params, "Extractor.G.", self._video_image(x))
        h = h.reshape(x.shape[0], -1)
        if cfg.conditional:
            h = torch.cat([h, labels.to(h.dtype)], dim=1)
        return linear(params, "Extractor.G.Output", h)

    # -- discriminators ------------------------------------------------------

    def _joint_head(self, params: Params, h: torch.Tensor,
                    z: torch.Tensor, labels: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """The (x, z) head shared by the frame D and the video D: leaky
        ``z1`` on the codes, concat with the x feature (and labels where
        given), leaky ``zx1``, ``Output``."""
        dr = self.cfg.dropout_rate
        hz = dropout(leaky_relu(linear(params, "Discriminator.z1", z)), dr)
        cat = [h, hz] + ([labels.to(h.dtype)] if labels is not None else [])
        h = dropout(leaky_relu(linear(params, "Discriminator.zx1",
                                      torch.cat(cat, dim=1))), dr)
        return linear(params, "Discriminator.Output", h).reshape(-1)

    def frame_discriminator(self, params: Params, x, z_g, z_l, labels
                            ) -> torch.Tensor:
        """Per-frame joint D(x, z_g, z_l, y) at B·LEN (``:265-311``)."""
        cfg = self.cfg
        h = self._conv_stack(params, "Discriminator.", self._frame_batch(x))
        h = h.reshape(h.shape[0], -1)
        lab = self._frame_labels(labels, z_g.dtype) if cfg.conditional \
            else None
        out = self._joint_head(params, h,
                               self._frame_codes(z_g, z_l, labels), lab)
        return shard_ctx.gather_frames(out, cfg.seq_len)

    def _mlp(self, params: Params, prefix: str, names, h: torch.Tensor
             ) -> torch.Tensor:
        dr = self.cfg.dropout_rate
        for name in names[:3]:
            h = dropout(leaky_relu(linear(params, prefix + name, h)), dr)
        return linear(params, prefix + names[3], h)

    def dynamic_discriminator_pairs(self, params: Params, z_l: torch.Tensor
                                    ) -> List[torch.Tensor]:
        """Every (z_t, z_{t+1}) pair through the weight-shared MLP in one
        batched call (``:313-331``); LEN-1 score vectors."""
        b, L = z_l.shape[:2]
        pairs = torch.cat([z_l[:, :-1], z_l[:, 1:]], dim=-1)
        out = self._mlp(params, "Discriminator.Dynamic.",
                        ("Input", "2", "3", "Output"),
                        pairs.reshape(b * (L - 1), -1)).reshape(b, L - 1)
        return list(out.unbind(dim=1))

    def zg_discriminator(self, params: Params, z_g: torch.Tensor
                         ) -> torch.Tensor:
        """``:333-349``."""
        return self._mlp(params, "Discriminator.ZG.",
                         ("Input", "2", "3", "Output"), z_g).reshape(-1)

    def ali_discriminator(self, params: Params, x, z_g, z_l, labels
                          ) -> torch.Tensor:
        """The video D per ``ali_mode`` (``:352-498``)."""
        cfg = self.cfg
        b, L = x.shape[0], cfg.seq_len
        dr = cfg.dropout_rate
        parts = [z_g, z_l.reshape(b, L * cfg.dim_latent_l).to(z_g.dtype)]
        if cfg.conditional:
            parts.append(labels.to(z_g.dtype))
        z = torch.cat(parts, dim=1)
        head_labels = None
        if cfg.ali_mode == "concat_x":
            h = self._conv_stack(params, "Discriminator.",
                                 self._video_image(x))
        elif cfg.ali_mode == "concat_z":
            h = self._conv_stack(params, "Discriminator.",
                                 self._frame_batch(x))
            # the first VALID K1 on a model path: 4x4 -> 1x1
            h = shard_ctx.gather_frames(
                conv2d(params, "Discriminator.5", h, stride=1,
                       padding="VALID"), L)
            if cfg.conditional:
                head_labels = labels
        else:
            hgt, wdt = cfg.image_hw
            h = x.reshape(b, L, cfg.channels, hgt, wdt).permute(
                0, 1, 3, 4, 2).contiguous()  # N, LEN, H, W, C
            sls = self._3dcnn_depths()
            h = dropout(leaky_relu(conv3d(params, "Discriminator.1", h,
                                          stride=2, stride_len=sls[0])), dr)
            for i in range(2, 5):
                h = conv3d(params, f"Discriminator.{i}", h, stride=2,
                           stride_len=sls[i - 1])
                h = dropout(bn_act(cfg.bn, params, f"Discriminator.BN{i}",
                                   h, "leaky_relu"), dr)
        return self._joint_head(params, h.reshape(b, -1), z, head_labels)

    # -- graph ----------------------------------------------------------------

    def normalize(self, raw: torch.Tensor) -> torch.Tensor:
        return normalize_input(self.cfg, raw, self.compute_dtype)

    def _split_batch(self, raw):
        """(videos, one-hot labels or None) of a batch: a dict
        ``{'x', 'y'}`` (moving-MNIST) or the videos alone (chairs)."""
        if isinstance(raw, dict):
            return raw["x"], raw.get("y") if self.cfg.conditional else None
        if self.cfg.conditional:
            raise ValueError("a conditional model takes {'x', 'y'} batches")
        return raw, None

    def infer(self, params: Params, x: torch.Tensor,
              labels: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q_z_l [B, LEN, dl], q_z_g [B, dlg]) of normalized videos."""
        q_z_l = self.dynamic_extractor(
            params, self.frame_extractor(params, x, labels))
        return q_z_l, self.g_extractor(params, x, labels)

    def _graph(self, params: Params, raw, d: Draws, gen: bool) -> Dict:
        """The tensors the mode's costs read (``ssgan_inference_moving_
        mnist.py:513-539``): ``gen`` True builds the G+E player's graph,
        False the D player's, with E and G under ``no_grad``."""
        cfg = self.cfg
        raw_x, labels = self._split_batch(raw)
        b, dev, dt = raw_x.shape[0], raw_x.device, self.compute_dtype
        t: Dict = {}
        with torch.set_grad_enabled(gen and torch.is_grad_enabled()):
            real_x = self.normalize(raw_x)
            q_z_l, q_z_g = self.infer(params, real_x, labels)
            if gen and cfg.mode in REC_MODES:
                t["rec_x"] = self.frame_generator(params, q_z_g, q_z_l,
                                                  labels)
            p_z_l_0 = d.normal("p_z_l_0", (b, cfg.dim_latent_l), dt, dev)
            p_z_l = self.dynamic_generator(params, p_z_l_0, d)
            p_z_g = d.normal("p_z_g", (b, cfg.dim_latent_g), dt, dev)
            p_y = None
            if cfg.conditional:
                p_y = F.one_hot(d.randint("p_y", cfg.n_classes, (b,), dev),
                                cfg.n_classes).float()
            fake_x = self.frame_generator(params, p_z_g, p_z_l, p_y)
        t.update(real_x=real_x, q_z_l=q_z_l, q_z_g=q_z_g, p_z_l=p_z_l,
                 p_z_g=p_z_g, p_y=p_y, fake_x=fake_x)
        if cfg.mode in LIST_MODES:
            t["disc_fake_list"] = (
                self.dynamic_discriminator_pairs(params, p_z_l)
                + [self.zg_discriminator(params, p_z_g),
                   self.frame_discriminator(params, fake_x, p_z_g, p_z_l,
                                            p_y)])
            t["disc_real_list"] = (
                self.dynamic_discriminator_pairs(params, q_z_l)
                + [self.zg_discriminator(params, q_z_g),
                   self.frame_discriminator(params, real_x, q_z_g, q_z_l,
                                            labels)])
        else:
            t["disc_real"] = self.ali_discriminator(params, real_x, q_z_g,
                                                    q_z_l, labels)
            t["disc_fake"] = self.ali_discriminator(params, fake_x, p_z_g,
                                                    p_z_l, p_y)
        return t

    def _costs(self, t, rec=None):
        """(gen cost, disc cost) of the mode (``:484-501``)."""
        cfg = self.cfg
        if cfg.mode in LIST_MODES:
            g, d, _, _ = objs.weighted_local_epce(
                t["disc_fake_list"], t["disc_real_list"], cfg.ratio,
                rec_penalty=rec)
            return g, d
        if cfg.mode == "ali":
            return objs.ali(t["disc_fake"], t["disc_real"])
        zero = torch.zeros((), device=t["real_x"].device)
        return objs.alice(t["disc_fake"], t["disc_real"],
                          zero if rec is None else rec)

    def gen_loss(self, params: Params, raw, generator=None,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """The G+E player's loss; aux ``gen_cost`` and, for local_epce-z
        and alice-z, ``rec_cost`` (lambda times the L2 distance)."""
        t = self._graph(params, raw, Draws(draws, generator), gen=True)
        rec = None
        if self.cfg.mode in REC_MODES:
            rec = self.cfg.lambda_ * penalties.distance(
                t["real_x"], t["rec_x"], "l2")
        g, _ = self._costs(t, rec)
        aux = {"gen_cost": g}
        if rec is not None:
            aux["rec_cost"] = rec
        return g, aux

    def disc_loss(self, params: Params, raw, generator=None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict]:
        """The D player's loss."""
        t = self._graph(params, raw, Draws(draws, generator), gen=False)
        _, d = self._costs(t)
        return d, {"disc_cost": d}

    # -- serving and eval forwards -------------------------------------------

    def sample(self, params: Params, z_l_0: torch.Tensor,
               z_g: torch.Tensor, labels: Optional[torch.Tensor],
               generator=None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """Videos [B, LEN, C·H·W] of given codes (``:579-583``); the chain's
        ``epsilon`` is drawn."""
        dt = self.compute_dtype
        z_l = self.dynamic_generator(params, z_l_0.to(dt),
                                     Draws(draws, generator))
        return self.frame_generator(params, z_g.to(dt), z_l, labels)

    def reconstruct(self, params: Params, raw_x: torch.Tensor,
                    labels: Optional[torch.Tensor] = None, generator=None,
                    draws=None) -> torch.Tensor:
        """G(E(x)) of raw videos [B, LEN, C·H·W]."""
        q_z_l, q_z_g = self.infer(params, self.normalize(raw_x), labels)
        return self.frame_generator(params, q_z_g, q_z_l, labels)

    def disentangle(self, params: Params, raw_x: torch.Tensor,
                    labels: Optional[torch.Tensor], dis_g: torch.Tensor,
                    dis_y: Optional[torch.Tensor]) -> torch.Tensor:
        """The inferred motion codes regenerated under a fixed global code
        and label (``:604-618``)."""
        x = self.normalize(raw_x)
        q_z_l = self.dynamic_extractor(
            params, self.frame_extractor(params, x, labels))
        return self.frame_generator(params, dis_g.to(self.compute_dtype),
                                    q_z_l, dis_y)

    # -- optimizer presets ----------------------------------------------------

    def opt_specs(self) -> Tuple[OptSpec, OptSpec]:
        """Adam(lr, beta1) for both players; ali passes beta2 as well
        (``ssgan...py:547-559``)."""
        cfg = self.cfg
        spec = optimizer_for(cfg.mode, lr=cfg.lr, beta1=cfg.beta1,
                             beta2=cfg.beta2 if cfg.mode == "ali" else None)
        return spec, spec
