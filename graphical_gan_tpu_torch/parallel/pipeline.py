"""Pipeline parallelism (GPipe) over a ``stage`` mesh axis
(``graphical_gan_tpu/parallel/pipeline.py``), one process per stage.

The adversarial-inference graph has a linear cut that is also the player
cut (``gan_inference_cifar10.py:285-291``): everything the generator player
owns runs before everything the discriminator player owns, so the stages
partition the parameters and their Adam moments disjointly:

    stage 0  (Generator.* + Extractor.*):  real_x -> q_z = E(real_x);
                                           p_z ~ N(0,I); fake_x = G(p_z)
    stage 1  (Discriminator.*):            D(real_x, q_z), D(fake_x, p_z)
                                           -> the player's cost

:func:`build_family1_stages4` cuts the conv trunks as well (cifar10 and
svhn ali): Extractor trunk | Extractor tail + Generator | Discriminator
trunk | Discriminator tail; stages 0-1 are the generator player, 2-3 the
discriminator.

The state keeps JAX's layout: each stage's parameters flattened in sorted
name order into one f32 row (:class:`StageTemplate`), padded to the
largest stage and stacked to ``packed [S, P]``, with Adam's ``m`` and
``v`` alike, ``t [S]`` (one step count per row) and ``step``; an npz of
it has JAX's keys (``k:packed``, ``k:m``, ``k:v``, ``k:t``, ``k:step``),
so a pipeline checkpoint of either package loads in the other. Rank s
holds row s (``place``); ``read_params`` and ``gather_state`` gather the
rows.

The schedule (JAX: one ``lax.scan`` of ``M + S - 1`` ticks under
``shard_map`` and ``jax.grad`` of it): each update runs GPipe's forward,
every stage on microbatches 0..M-1 in order, each stage starting a
microbatch as soon as its input arrives, then the backward in reverse
microbatch order. Stage boundaries are the autograd functions ``_Send``
and ``_Recv``: the forward sends the activation to the next stage, and
the backward returns its gradient to the previous one, so one
``torch.autograd.grad`` per microbatch and stage runs that stage's
backward with both transfers inside it. The transfers are broadcasts over
a group of the two neighbouring ranks: ``all_reduce`` and ``broadcast``
are the collectives every backend takes on every tensor
(``parallel/collectives.py``; gloo on CUDA tensors refused
``all_to_all``), where point-to-point ``send``/``recv`` on CUDA tensors
over gloo is not known to work. No activation crosses a boundary in any
other way, and no double backward does: the wali-gp penalty
differentiates D inside the last stage, and ``_Recv``'s backward refuses
to be differentiated.

Semantics, as JAX's: with ``M`` equal microbatches every mean-over-batch
cost is the full-batch cost; batch-statistics BN sees microbatch
statistics (stage 0's BNs run K2a, K2b and K2c+K2d at one launch over the
microbatch's rows, never their split modes). The generator's rows update
only on G steps and the discriminator's only on D steps, TF1-Adam per row
with its own step count (JAX ``:738-760``). A stage whose player does not
update and whose input gradient no earlier updating stage needs runs its
forward only: JAX computes those gradients and masks them out, so the
rows come out bit-identical either way. Each (update, stage, microbatch)
draws from its own stream, as JAX's ``_stage_key``; a draw given in
``noise`` (the parity tests pass JAX's) is used instead.

Scope, as JAX's: family 1 with ali and wali-gp, GMGAN with ali and
local_ep (every MODE_K: REINFORCE's ``max q(k|x)`` rides the activation
to the last stage), 4 stages for cifar10 and svhn ali; Adam players only,
f32 parameters, no weight clipping, no ``lr_scale``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphical_gan_tpu_torch.models.common import Draws
from graphical_gan_tpu_torch.parallel.collectives import (
    Group, broadcast, gather_stack)

Params = Dict[str, torch.Tensor]

N_STAGES = 2


# -- parameter packing ----------------------------------------------------------

class StageTemplate:
    """The fixed (name, shape, offset, size) layout of one stage's
    parameters in its f32 row, names sorted (JAX ``:86-110``)."""

    def __init__(self, shapes: Dict[str, Sequence[int]], names: List[str]):
        self.entries = []
        off = 0
        for n in sorted(names):
            shape = tuple(int(d) for d in shapes[n])
            size = int(np.prod(shape)) if shape else 1
            self.entries.append((n, shape, off, size))
            off += size
        self.size = off

    @property
    def names(self) -> List[str]:
        return [e[0] for e in self.entries]

    def pack(self, params: Params) -> torch.Tensor:
        parts = [params[n].detach().float().reshape(-1)
                 for n, _, _, _ in self.entries]
        return torch.cat(parts) if parts else torch.zeros(0)

    def unpack(self, flat: torch.Tensor) -> Params:
        """Views of ``flat`` by name (clone them to own them)."""
        return {n: flat[off:off + size].reshape(shape)
                for n, shape, off, size in self.entries}


def _shapes(model) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(spec[1]) for n, spec in model.param_specs().items()}


def _check_f32(model) -> None:
    if getattr(model.cfg, "param_dtype", "float32") != "float32":
        raise NotImplementedError("pipeline parallelism keeps f32 params "
                                  "(packed stage buffers)")


def _player_stage_names(model) -> Tuple[List[str], List[str]]:
    """The two players' parameter names (JAX ``:112-121``); a parameter
    outside both raises."""
    names = list(_shapes(model))
    s0 = [n for n in names if any(s in n for s in model.GEN_PLAYER)]
    s1 = [n for n in names if any(s in n for s in model.DISC_PLAYER)]
    leftover = set(names) - set(s0) - set(s1)
    if leftover:
        raise ValueError(f"params outside the player partition: {leftover}")
    return s0, s1


class Stages:
    """A model's cut: one template and one function per stage, the width
    of each boundary's activation and the generator player's rows.

    ``fns[s](params, inp, draws, player)``: stage s on one microbatch
    (``inp`` the raw rows for stage 0, else the previous stage's f32
    activation); every stage but the last returns its f32 activation
    ``[mb, widths[s]]``, the last the cost of ``player`` ("gen" or
    "disc")."""

    def __init__(self, templates, fns, widths, gen_rows):
        self.templates = list(templates)
        self.fns = list(fns)
        self.widths = list(widths)
        self.gen_rows = list(gen_rows)

    @property
    def n(self) -> int:
        return len(self.templates)

    @property
    def disc_rows(self) -> List[int]:
        return [r for r in range(self.n) if r not in self.gen_rows]


def _split(buf: torch.Tensor, widths: Sequence[int]) -> List[torch.Tensor]:
    return list(torch.split(buf, list(widths), dim=1))


def _f32_cat(parts) -> torch.Tensor:
    return torch.cat([a.float() for a in parts], dim=1)


def build_family1_stages(model) -> Stages:
    """Family 1's player cut, ali and wali-gp (JAX ``:128-190``)."""
    from graphical_gan_tpu_torch.models import networks
    from graphical_gan_tpu_torch.objectives import gan_inference as objs
    from graphical_gan_tpu_torch.objectives import penalties

    cfg = model.cfg
    if cfg.mode not in ("ali", "wali-gp"):
        raise NotImplementedError(
            "pipeline parallelism supports modes 'ali' and 'wali-gp' "
            f"(got {cfg.mode!r})")
    _check_f32(model)
    shapes = _shapes(model)
    names0, names1 = _player_stage_names(model)
    d_x, d_z = cfg.data.output_dim, cfg.dim_latent
    widths = [d_x, d_z, d_x, d_z]           # real_x | q_z | fake_x | p_z
    cdt = model.compute_dtype

    def stage0(p, x_mb, d, player):
        real_x = model.normalize(x_mb, d)
        q_z, _, _ = networks.extractor(cfg, p, real_x, d, "eps_q")
        p_z = d.normal("p_z", (x_mb.shape[0], d_z), cdt, x_mb.device)
        fake_x, _, _ = networks.generator(cfg, p, p_z)
        return _f32_cat((real_x, q_z, fake_x, p_z))

    def stage1(p, buf, d, player):
        real_x, q_z, fake_x, p_z = [a.to(cdt) for a in _split(buf, widths)]

        def disc(x, z):
            return networks.discriminator_xz(cfg, p, x, z)

        disc_real, disc_fake = disc(real_x, q_z), disc(fake_x, p_z)
        if cfg.mode == "ali":
            g, dc = objs.ali(disc_fake, disc_real)
            return g if player == "gen" else dc
        if player == "gen":  # the gen cost reads no penalty
            return objs.wali_gp(disc_fake, disc_real,
                                torch.zeros((), device=buf.device))[0]
        # the penalty is this stage's own: its inner gradient closes over
        # D alone, so the double backward stays inside the stage
        alpha = d.uniform("alpha", (buf.shape[0], 1), buf.device)
        gp = penalties.gradient_penalty_xz(disc, real_x, fake_x, q_z, p_z,
                                           alpha, cfg.gp_lambda)
        return objs.wali_gp(disc_fake, disc_real, gp)[1]

    return Stages([StageTemplate(shapes, names0),
                   StageTemplate(shapes, names1)],
                  [stage0, stage1], [sum(widths)], [0])


def build_gmgan_stages(model) -> Stages:
    """GMGAN's player cut, ali and local_ep, every MODE_K (JAX
    ``:197-283``): stage 0 owns Generator.* (the mixture means
    ``Generator.Hyper.Mu`` among them) and Extractor.*."""
    import torch.nn.functional as F
    from graphical_gan_tpu_torch.models import networks
    from graphical_gan_tpu_torch.objectives import discrete
    from graphical_gan_tpu_torch.objectives import gan_inference as objs

    cfg = model.cfg
    if cfg.mode not in ("ali", "local_ep"):
        raise NotImplementedError(
            "gmgan pipeline parallelism supports modes 'ali' and "
            f"'local_ep' (got {cfg.mode!r})")
    _check_f32(model)
    shapes = _shapes(model)
    names0, names1 = _player_stage_names(model)
    d_x, d_z, n_k = cfg.data.output_dim, cfg.dim_latent, cfg.n_coms
    # real_x | q_z | q_k | fake_x | p_z | hyper_p_k | max q(k|x)
    widths = [d_x, d_z, n_k, d_x, d_z, n_k, 1]
    cdt = model.compute_dtype

    def stage0(p, x_mb, d, player):
        b, dev = x_mb.shape[0], x_mb.device
        real_x = model.normalize(x_mb, d)
        q_z, _, _ = networks.extractor(cfg, p, real_x, d)
        logits = model.component_logits(p, q_z)
        q_k = model.posterior_sample(logits, d, "gumbel_q")
        q_k_prob_max = torch.softmax(logits, dim=1).max(
            dim=1, keepdim=True).values
        eps = d.normal("hyper_p_z", (b, d_z), torch.float32, dev)
        idx = d.randint("prior_idx", n_k, (b,), dev)
        p_k = F.one_hot(idx, n_k).float()
        p_z = model.hyper_generator(p, p_k, eps).to(cdt)
        fake_x, _, _ = networks.generator(cfg, p, p_z)
        return _f32_cat((real_x, q_z, q_k, fake_x, p_z, p_k, q_k_prob_max))

    def stage1(p, buf, d, player):
        parts = _split(buf, widths)
        real_x, q_z, q_k, fake_x, p_z, p_k = [a.to(cdt) for a in parts[:6]]
        q_k_prob_max = parts[6][:, 0].float()
        if cfg.mode == "local_ep":
            disc_fake = [model.hyper_discriminator(p, p_z, p_k),
                         model.discriminator_xz(p, fake_x, p_z)]
            disc_real = [model.hyper_discriminator(p, q_z, q_k),
                         model.discriminator_xz(p, real_x, q_z)]
            f_k = disc_real[0]
        else:
            disc_real = model.discriminator_xzk(p, real_x, q_z, q_k)
            disc_fake = model.discriminator_xzk(p, fake_x, p_z, p_k)
            f_k = disc_real
        s_f = None
        if cfg.mode_k == "REINFORCE" and player == "gen":
            s_f = discrete.score_function(f_k, q_k_prob_max,
                                          cfg.control_variate).mean()
        cost = objs.local_ep if cfg.mode == "local_ep" else objs.ali
        g, dc = cost(disc_fake, disc_real, s_f)
        return g if player == "gen" else dc

    return Stages([StageTemplate(shapes, names0),
                   StageTemplate(shapes, names1)],
                  [stage0, stage1], [sum(widths)], [0])


def build_stages(model) -> Stages:
    """The 2-stage player cut of either family."""
    from graphical_gan_tpu_torch.models.gmgan import GMGanModel
    if isinstance(model, GMGanModel):
        return build_gmgan_stages(model)
    return build_family1_stages(model)


def build_family1_stages4(model) -> Stages:
    """The 4-stage family-1 ali cut (JAX ``:299-421``), cifar10 and svhn
    only: mnist names a conv and a linear 'Discriminator.2' (the
    reference's own collision), which a prefix partition cannot split,
    and wali-gp's penalty differentiates the whole D, which would cross
    the 2 | 3 boundary.

        stage 0  Extractor convs 1-2 (+BN2):   real_x -> e_feat
        stage 1  Extractor tail + Generator:   e_feat -> q_z;
                                               p_z ~ N(0,I) -> fake_x
        stage 2  Discriminator conv trunk:     (real_x, fake_x) -> d_feats
        stage 3  Discriminator (x, z) tail:    -> the player's cost

    Each boundary carries its own width (JAX pads all three to the
    widest, its one ring buffer's; the values are the same)."""
    from graphical_gan_tpu_torch.models import networks
    from graphical_gan_tpu_torch.objectives import gan_inference as objs
    from graphical_gan_tpu_torch.ops.layout import unflatten_image

    cfg = model.cfg
    if cfg.mode != "ali" or cfg.dataset not in ("cifar10", "svhn"):
        raise NotImplementedError(
            "the 4-stage pipeline cut supports cifar10/svhn ali "
            f"(got {cfg.dataset!r} {cfg.mode!r})")
    _check_f32(model)
    shapes = _shapes(model)
    names = list(shapes)
    pre0 = ("Extractor.1.", "Extractor.2.", "Extractor.BN2.")
    pre2 = ("Discriminator.1.", "Discriminator.2.", "Discriminator.3.")
    names0 = [n for n in names if n.startswith(pre0)]
    names2 = [n for n in names if n.startswith(pre2)]
    names1 = [n for n in names if n.startswith(("Extractor.", "Generator."))
              and n not in names0]
    names3 = [n for n in names if n.startswith("Discriminator.")
              and n not in names2]
    cover = set(names0) | set(names1) | set(names2) | set(names3)
    if cover != set(names):
        raise ValueError(f"params outside the 4-stage partition: "
                         f"{set(names) - cover}")
    templates = [StageTemplate(shapes, ns)
                 for ns in (names0, names1, names2, names3)]

    h_img, w_img = cfg.data.image_hw
    ch, dim = cfg.data.channels, cfg.dim
    d_x, d_z = cfg.data.output_dim, cfg.dim_latent
    eh, ew = h_img // 4, w_img // 4          # after two stride-2 convs
    e_feat = eh * ew * 2 * dim
    d_feat = 4 * 4 * 4 * dim
    widths = [d_x + e_feat, 2 * d_x + 2 * d_z, 2 * d_feat + 2 * d_z]
    cdt = model.compute_dtype

    def image(x):
        return unflatten_image(x.to(cdt), ch, h_img, w_img)

    def stage0(p, x_mb, d, player):
        real_x = model.normalize(x_mb, d)
        h = networks.extractor_front(cfg, p, image(real_x))
        return _f32_cat((real_x, h.reshape(h.shape[0], -1)))

    def stage1(p, buf, d, player):
        real_x, h = _split(buf, [d_x, e_feat])
        h = h.to(cdt).reshape(-1, eh, ew, 2 * dim)
        q_z, _, _ = networks.extractor_back(cfg, p, h, d)
        p_z = d.normal("p_z", (buf.shape[0], d_z), cdt, buf.device)
        fake_x, _, _ = networks.generator(cfg, p, p_z)
        return _f32_cat((real_x, q_z, fake_x, p_z))

    def stage2(p, buf, d, player):
        real_x, q_z, fake_x, p_z = _split(buf, [d_x, d_z, d_x, d_z])
        h_real = networks.discriminator_x_trunk(cfg, p, image(real_x))
        h_fake = networks.discriminator_x_trunk(cfg, p, image(fake_x))
        return _f32_cat((h_real, h_fake, q_z, p_z))

    def stage3(p, buf, d, player):
        h_real, h_fake, q_z, p_z = [a.to(cdt) for a in _split(
            buf, [d_feat, d_feat, d_z, d_z])]
        disc_real = networks.discriminator_xz_head(cfg, p, h_real, q_z)
        disc_fake = networks.discriminator_xz_head(cfg, p, h_fake, p_z)
        g, dc = objs.ali(disc_fake, disc_real)
        return g if player == "gen" else dc

    return Stages(templates, [stage0, stage1, stage2, stage3], widths,
                  [0, 1])


def normalized_stages(model, n_stages: int) -> Stages:
    """The cut for ``n_stages`` (JAX ``_normalized_stages``): 2, the
    player cut of either family, or 4, family 1's conv-trunk cut."""
    if n_stages == 2:
        return build_stages(model)
    if n_stages == 4:
        return build_family1_stages4(model)
    raise ValueError(f"unsupported pipeline stage count {n_stages} (2|4)")


def pack_stacked(params: Params, templates) -> torch.Tensor:
    """The stages' rows stacked to ``[S, Pmax]``, zero-padded."""
    pmax = max(t.size for t in templates)
    rows = []
    for t in templates:
        flat = t.pack(params)
        rows.append(torch.nn.functional.pad(flat, (0, pmax - t.size)))
    return torch.stack(rows)


def unpack_stacked(stacked: torch.Tensor, templates) -> Params:
    """Name-keyed parameters, each a copy of its row's slice."""
    out = {}
    for i, t in enumerate(templates):
        out.update({n: v.clone() for n, v in t.unpack(stacked[i]).items()})
    return out


# -- the state and its migrations ----------------------------------------------

def _state(packed: torch.Tensor, m=None, v=None, t=None, step: int = 0
           ) -> Dict:
    return dict(packed=packed,
                m=torch.zeros_like(packed) if m is None else m,
                v=torch.zeros_like(packed) if v is None else v,
                t=torch.zeros((packed.shape[0],), dtype=torch.int32)
                if t is None else t, step=int(step))


def pp_state_like(model, n_stages: int = N_STAGES, device="cpu") -> Dict:
    """A zero pp state of the right shapes (the ``like`` of a restore)."""
    templates = normalized_stages(model, n_stages).templates
    pmax = max(t.size for t in templates)
    return _state(torch.zeros((len(templates), pmax), device=device))


def _adam_opts(*opts) -> None:
    for opt in opts:
        if not isinstance(opt, dict) or "m" not in opt or "master" in opt:
            raise NotImplementedError(
                "pp checkpoint conversion requires the plain-Adam f32 "
                "configuration for both players (no bf16 masters)")


def pp_state_from_train_state(model, ts, n_stages: int = N_STAGES) -> Dict:
    """A standard TrainState (dp, tp, sp, ep or one device) as the pp
    state of ``n_stages`` rows, its optimizer state carried over (JAX
    ``:469-498``)."""
    stages = normalized_stages(model, n_stages)
    _adam_opts(ts.gen_opt, ts.disc_opt)
    packed = pack_stacked(ts.params, stages.templates)
    opt_of = [ts.gen_opt if s in stages.gen_rows else ts.disc_opt
              for s in range(stages.n)]

    def rows(field):
        return torch.stack([torch.nn.functional.pad(
            t.pack(opt[field]).to(packed.device),
            (0, packed.shape[1] - t.size))
            for t, opt in zip(stages.templates, opt_of)])

    t = torch.stack([torch.as_tensor(opt["t"]).to(torch.int32).cpu()
                     for opt in opt_of])
    return _state(packed, rows("m"), rows("v"), t, int(ts.step))


def train_state_from_pp_state(model, pp_state, std_init_state):
    """The inverse (JAX ``:501-529``): the stage count read from the
    packed rows; ``std_init_state`` is the standard step's ``init_state``,
    whose m and v are filled from the rows."""
    n_stages = int(pp_state["packed"].shape[0])
    stages = normalized_stages(model, n_stages)
    params = unpack_stacked(pp_state["packed"], stages.templates)
    like = std_init_state(params)
    _adam_opts(like.gen_opt, like.disc_opt)
    for field in ("m", "v"):
        g, d = {}, {}
        for s, tmpl in enumerate(stages.templates):
            (g if s in stages.gen_rows else d).update(
                {n: x.clone() for n, x in
                 tmpl.unpack(pp_state[field][s]).items()})
        like.gen_opt[field], like.disc_opt[field] = g, d
    t = torch.as_tensor(pp_state["t"]).to(torch.int32).cpu()
    like.gen_opt["t"] = t[stages.gen_rows[0]].clone()
    like.disc_opt["t"] = t[stages.disc_rows[0]].clone()
    like.step = int(pp_state["step"])
    return like


def restore_pp_params(model, ckpt_path: str, device="cpu"):
    """(name-keyed params, extra) of a pipeline checkpoint of any stage
    count, npz or sharded (JAX ``:532-559``)."""
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
    n = ckpt_lib.leaf_shapes(ckpt_path)["k:packed"][0]
    state, extra = ckpt_lib.restore_state(ckpt_path,
                                    pp_state_like(model, n, device))
    return unpack_stacked(state["packed"],
                          normalized_stages(model, n).templates), extra


# -- the one-process reference ------------------------------------------------

def stage_seed(seed: int, update: int, stage: int, microbatch: int) -> int:
    """The seed of (update, stage, microbatch)'s stream under the step's
    ``seed``."""
    s = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), update, stage,
                                microbatch]).generate_state(2)
    return int((int(s[0]) << 31) ^ int(s[1]))


def _draws(noise, update: int, j: int, disc_only, seed: Optional[int],
           stage: int, generator) -> Draws:
    """(update, stage, microbatch)'s Draws: ``noise[name][u][j]`` where
    given (a draw only D updates make indexed over the D updates), else
    its own stream (``generator`` seeded from ``seed``)."""
    given = {}
    if noise is not None:
        for name, t in noise.items():
            if name in disc_only:
                if update == 0:
                    continue
                given[name] = t[update - 1][j]
            else:
                given[name] = t[update][j]
    if generator is not None and seed is not None:
        generator.manual_seed(stage_seed(seed, update, stage, j))
    return Draws(given, generator)


def sequential_staged_losses(model, params: Params, raw: torch.Tensor,
                             microbatches: int, n_stages: int = 2,
                             noise: Optional[Dict] = None, update: int = 0,
                             player: str = "gen", generator=None,
                             seed: Optional[int] = None) -> torch.Tensor:
    """The pipeline's math stage by stage in one process (JAX
    ``:575-595``): per microbatch j every stage in order, the player's
    cost averaged over the microbatches; differentiable in ``params``.
    ``noise`` as the step takes it (``make_pp_train_step``)."""
    stages = normalized_stages(model, n_stages)
    mb = raw.shape[0] // microbatches
    total = torch.zeros((), device=raw.device)
    for j in range(microbatches):
        carry = raw[j * mb:(j + 1) * mb]
        for s in range(stages.n):
            d = _draws(noise, update, j, model.DISC_ONLY_DRAWS, seed, s,
                       generator)
            carry = stages.fns[s](params, carry, d, player)
        total = total + carry.float()
    return total * (1.0 / microbatches)


# -- the optimizer on packed rows ----------------------------------------------

def _row_optimizers(model, stages: Stages) -> Dict:
    """Each row's Adam, its player's (JAX ``row_arr``); a player that is
    not Adam, or clips its weights, is refused (JAX ``:717-723``)."""
    from graphical_gan_tpu_torch.optim.optimizers import Adam
    gen_spec, disc_spec = model.opt_specs()
    for spec in (gen_spec, disc_spec):
        if spec is None or spec.kind != "adam" \
                or spec.weight_clip is not None:
            raise NotImplementedError(
                "pipeline step implements the Adam players "
                "(ali / wali-gp / gmgan local_ep presets)")
    return {r: Adam(lr=sp.lr, beta1=sp.beta1, beta2=sp.beta2, eps=sp.eps)
            for r, sp in ((r, gen_spec if r in stages.gen_rows
                           else disc_spec) for r in range(stages.n))}


def _check_batch(cfg, microbatches: int) -> None:
    if cfg.batch_size % microbatches:
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                         f"microbatches={microbatches}")


def _count(t: torch.Tensor, rows) -> torch.Tensor:
    """``t`` with one more step on each of ``rows``."""
    t = t.clone()
    for r in rows:
        t[r] += 1
    return t


@torch.no_grad()
def _adam_row(opt, t: int, p: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, g: torch.Tensor) -> None:
    """TF1-Adam in place on one packed row at its step count ``t``, as
    JAX's ``masked_adam`` computes a row: ``p -= lr_t * m / (sqrt(v) +
    eps)``."""
    lr_t = opt.lr_t(t)
    m.mul_(opt.beta1).add_(g, alpha=1.0 - opt.beta1)
    v.mul_(opt.beta2).addcmul_(g, g, value=1.0 - opt.beta2)
    p.sub_(m * lr_t / (v.sqrt() + opt.eps))


def make_staged_reference_step(model, microbatches: int = 4,
                               critic_iters: Optional[int] = None,
                               n_stages: int = N_STAGES):
    """``(step, init_state)``: the pipeline step's math in one process,
    on the full state (:func:`sequential_staged_losses` and the masked
    row Adam), with ``make_pp_train_step``'s signature and draws: the
    reference the ranks' step is held to."""
    cfg = model.cfg
    k = cfg.critic_iters if critic_iters is None else critic_iters
    stages = normalized_stages(model, n_stages)
    _check_batch(cfg, microbatches)
    adam = _row_optimizers(model, stages)
    templates = stages.templates

    def update(state, raw, u, player, rows, seed, noise, train):
        packed = state["packed"]
        leaves = {n: x.requires_grad_(train) for n, x in
                  unpack_stacked(packed, templates).items()}
        stream = None if seed is None else torch.Generator(packed.device)
        with torch.set_grad_enabled(train):
            cost = sequential_staged_losses(
                model, leaves, raw, microbatches, stages.n, noise, u,
                player, stream, seed)
        if not train:
            return cost.detach()
        names = [n for r in rows for n in templates[r].names]
        grads = dict(zip(names, torch.autograd.grad(
            cost, [leaves[n] for n in names], allow_unused=True)))
        state["t"] = _count(state["t"], rows)
        for r in rows:
            g = torch.zeros_like(packed[r])
            flat = [torch.zeros_like(leaves[n]) if grads[n] is None
                    else grads[n] for n in templates[r].names]
            g[:templates[r].size] = torch.cat([x.reshape(-1).float()
                                               for x in flat])
            _adam_row(adam[r], int(state["t"][r]), packed[r],
                      state["m"][r], state["v"][r], g)
        return cost.detach()

    def step(state, raw_batches, do_gen, generator=None, noise=None):
        seed = None if generator is None else generator.initial_seed()
        metrics = {"gen_cost": update(state, raw_batches[0], 0, "gen",
                                      stages.gen_rows, seed, noise,
                                      bool(do_gen))}
        for i in range(k):
            metrics["disc_cost"] = update(
                state, raw_batches[1 + i], 1 + i, "disc", stages.disc_rows,
                seed, noise, True)
        state["step"] = int(state["step"]) + 1
        return state, metrics

    def init_state(params: Params) -> Dict:
        return _state(pack_stacked(params, templates))

    return step, init_state


# -- the boundaries -------------------------------------------------------------

class _Send(torch.autograd.Function):
    """Forward: ``x`` to the next stage over ``link`` (this rank its
    index 0). Backward: x's gradient, received from the next stage. The
    output is an empty marker, the root of this stage's backward."""

    @staticmethod
    def forward(ctx, x, link, clock):
        ctx.link, ctx.clock = link, clock
        ctx.meta = (x.shape, x.dtype, x.device)
        broadcast(x.detach().contiguous(), link, 0)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        g = torch.empty(shape, dtype=dtype, device=device)
        with ctx.clock.waiting():
            broadcast(g, ctx.link, 1)
        return g, None, None


class _Recv(torch.autograd.Function):
    """Forward: the previous stage's activation over ``link`` (this rank
    its index 1). Backward: its gradient, sent back."""

    @staticmethod
    def forward(ctx, anchor, link, shape, device, clock):
        ctx.link = link
        buf = torch.empty(shape, dtype=torch.float32, device=device)
        with clock.waiting():
            broadcast(buf, link, 0)
        return buf

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError("a double backward reached a pipeline "
                               "boundary; it must stay inside its stage")
        broadcast(g.contiguous(), ctx.link, 1)
        return None, None, None, None, None


class _Clock:
    """The seconds a rank waits (``wait``: for its neighbours at the
    boundaries and for the last stage's costs at the step's end) and its
    steps' seconds (``total``): the pipeline's bubble as this rank sees
    it."""

    def __init__(self):
        self.wait = 0.0
        self.total = 0.0

    @contextlib.contextmanager
    def waiting(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wait += time.perf_counter() - t0


# -- the step -------------------------------------------------------------------

def _links(mesh, n_stages: int) -> List[Group]:
    """The group of ranks (s, s+1) for each boundary s; every rank makes
    every group, in order."""
    import torch.distributed as dist
    rank = mesh.rank
    out = []
    for s in range(n_stages - 1):
        pg = dist.new_group([s, s + 1])
        out.append(Group(pg, 2, rank - s) if rank in (s, s + 1) else None)
    return out


def make_pp_train_step(model, mesh, microbatches: int = 4,
                       critic_iters: Optional[int] = None,
                       stage_axis: str = "stage",
                       n_stages: Optional[int] = None):
    """The alternating G/D step as a parameter-partitioned pipeline over
    ``mesh[stage_axis]`` (JAX ``:695-826``): 2 stages (the player cut)
    or 4 (family 1's conv-trunk cut), by default the axis's size.

    Returns ``(step, init_state, place, read_params)``:
    ``step(state, raw_batches, do_gen, generator=None, noise=None)`` as
    the other strategies' steps (``raw_batches`` [1+k, B, ...] global;
    stage 0 reads it), ``noise[name]`` stacked [1+k, M, B/M, ...] over
    the updates and microbatches ([k, M, ...] for a draw only D updates
    make); the metrics come back on every rank. ``init_state(params)``
    is the full state (``packed [S, P]``), ``place`` keeps this rank's
    row, ``read_params`` gives the name-keyed parameters of a full or a
    placed state (gathering the rows: every rank calls it).
    ``step.gather_state`` is the full state of a placed one,
    ``step.shard_spec`` which leaves a placed state holds in slices, and
    ``step.clock`` the seconds this rank waited at its boundaries."""
    if n_stages is None:
        n_stages = int(mesh.shape[stage_axis])
    if int(mesh.shape.get(stage_axis, 0)) != n_stages:
        raise ValueError(f"mesh[{stage_axis!r}] must be {n_stages}")
    cfg = model.cfg
    k = cfg.critic_iters if critic_iters is None else critic_iters
    stages = normalized_stages(model, n_stages)
    _check_batch(cfg, microbatches)
    templates, n_s = stages.templates, stages.n
    pmax = max(t.size for t in templates)
    group = mesh.group(stage_axis)
    s = group.index if group is not None else 0
    links = _links(mesh, n_s)
    device = mesh.device
    mb = cfg.batch_size // microbatches
    adam = _row_optimizers(model, stages)
    clock = _Clock()
    stream = torch.Generator(device=device)

    def masked_adam(state, grad_row, rows):
        """TF1-Adam on this rank's row where it is one of the player's
        ``rows``; every rank counts the rows' steps."""
        state["t"] = _count(state["t"], rows)
        if s in rows:
            _adam_row(adam[s], int(state["t"][s]), state["packed"][0],
                      state["m"][0], state["v"][0], grad_row)

    def update(state, raw, u, player, rows, seed, noise, train):
        """One update's pipeline on this rank: its stage's forward over
        the microbatches, then (``train``) the backward and the masked
        Adam of ``rows``; the cost on the last stage, else None."""
        first = min(rows)
        backward = train and s >= first
        want_params = train and s in rows
        want_input = backward and s > first
        tmpl = templates[s]
        row = state["packed"][0, :tmpl.size]
        leaves = {n: x.detach().clone().requires_grad_(want_params)
                  for n, x in tmpl.unpack(row).items()}
        gen = stream if seed is not None else None
        fn = stages.fns[s]
        outs, anchors, cost = [], [], None
        with torch.set_grad_enabled(backward):
            for j in range(microbatches):
                d = _draws(noise, u, j, model.DISC_ONLY_DRAWS, seed, s, gen)
                if s == 0:
                    inp = raw[j * mb:(j + 1) * mb]
                else:
                    anchor = torch.zeros((), device=device,
                                         requires_grad=want_input)
                    inp = _Recv.apply(anchor, links[s - 1],
                                      (mb, stages.widths[s - 1]), device,
                                      clock)
                    anchors.append(anchor)
                out = fn(leaves, inp, d, player)
                if s < n_s - 1:
                    outs.append(_Send.apply(out, links[s], clock))
                else:
                    outs.append(out)
                    c = out.detach().float()
                    cost = c if cost is None else cost + c
        if cost is not None:
            cost = cost * (1.0 / microbatches)
        if not backward:
            if train:  # every rank counts the player's steps
                masked_adam(state, None, rows)
            return cost
        names = list(leaves) if want_params else []
        sums = None
        inv = torch.full((), 1.0 / microbatches, device=device)
        for j in reversed(range(microbatches)):
            targets = [leaves[n] for n in names]
            if want_input:
                targets.append(anchors[j])
            root = outs[j]
            grads = torch.autograd.grad(
                root, targets, grad_outputs=inv if s == n_s - 1
                else torch.zeros((), device=device), allow_unused=True)
            if want_params:
                g = [torch.zeros_like(leaves[n]) if x is None else x
                     for n, x in zip(names, grads[:len(names)])]
                if sums is None:
                    sums = [x.float().clone() for x in g]
                else:
                    torch._foreach_add_(sums, [x.float() for x in g])
            outs[j] = None
        if want_params:
            grad_row = torch.zeros(pmax, device=device)
            grad_row[:tmpl.size] = torch.cat([x.reshape(-1) for x in sums])
            masked_adam(state, grad_row, rows)
        else:
            masked_adam(state, None, rows)
        return cost

    def step(state, raw_batches, do_gen, generator=None, noise=None):
        t0 = time.perf_counter()
        raw = raw_batches.to(device) if s == 0 else None
        seed = None if generator is None else generator.initial_seed()
        g_rows, d_rows = stages.gen_rows, stages.disc_rows
        gen_cost = update(state, None if raw is None else raw[0], 0, "gen",
                          g_rows, seed, noise, bool(do_gen))
        disc_cost = None
        for i in range(k):
            disc_cost = update(state, None if raw is None else raw[1 + i],
                               1 + i, "disc", d_rows, seed, noise, True)
        vals = torch.zeros(2, device=device)
        if s == n_s - 1:
            vals[0] = gen_cost
            if disc_cost is not None:
                vals[1] = disc_cost
        with clock.waiting():  # for the last stage's costs
            broadcast(vals, mesh.world, n_s - 1)
        metrics = {"gen_cost": vals[0]}
        if k > 0:
            metrics["disc_cost"] = vals[1]
        state["step"] = int(state["step"]) + 1
        clock.total += time.perf_counter() - t0
        return state, metrics

    def init_state(params: Params) -> Dict:
        return _state(pack_stacked(params, templates))

    def place(state: Dict) -> Dict:
        """Rank 0's state on every rank (a broadcast), this rank's row
        kept, on its device."""
        full = {n: broadcast(state[n].detach().to(device).clone(),
                             mesh.world) for n in ("packed", "m", "v")}
        return dict(packed=full["packed"][s:s + 1].clone(),
                    m=full["m"][s:s + 1].clone(),
                    v=full["v"][s:s + 1].clone(),
                    t=torch.as_tensor(state["t"]).to(torch.int32).cpu()
                    .clone(), step=int(state["step"]))

    def gather_state(state: Dict) -> Dict:
        """The full state of a placed one (every rank calls it)."""
        if state["packed"].shape[0] == n_s:
            return state
        rows = {n: gather_stack(state[n][0].contiguous(), group)
                for n in ("packed", "m", "v")}
        return dict(rows, t=state["t"].clone(), step=int(state["step"]))

    def read_params(state: Dict) -> Params:
        return unpack_stacked(gather_state(state)["packed"], templates)

    def shard_spec(state: Dict) -> Dict[str, Tuple[int, int, int]]:
        """keypath -> (dim, index, count) of the leaves a placed state
        holds in slices (``train/checkpoint_orbax.py``)."""
        if state["packed"].shape[0] == n_s:
            return {}
        return {f"k:{n}": (0, s, n_s) for n in ("packed", "m", "v")}

    step.gather_state = gather_state
    step.shard_spec = shard_spec
    step.clock = clock
    step.stage = s
    return step, init_state, place, read_params
