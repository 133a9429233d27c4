"""The alternating train step (``graphical_gan_tpu/train/step.py:98-251``).

One iteration is one G+E update (skipped at iteration 0, as the reference
does) and then k D updates, each on its own batch slice: slice 0 feeds the
G update and slice 1+i the i-th D update; ``disc_cost`` is the last D
update's loss. Each update differentiates its player's loss with respect to
that player's parameters only (``torch.autograd.grad`` on detached leaves),
so no gradient of the frozen player is computed, and the optimizer then
overwrites the parameters in place.

Where the JAX step is one jitted XLA program, this one runs eagerly on the
port's kernels. A mode without a discriminator (k = 0: vegan-mmd, -kl,
-ikl, -jsd, vae) has ``disc_opt == {}`` and runs the G update alone; wali's
D updates clip the D parameters after each step, as JAX's do. The random
draws come from one ``torch.Generator``, or from ``noise`` when the caller
passes them in (the names are the model's, ``models/gan_inference.py``).
Gradient accumulation (``accum_steps > 1``) and rematerialization
(``remat``) come later; they raise here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from graphical_gan_tpu_torch.core.registry import merge, partition
from graphical_gan_tpu_torch.optim.optimizers import (
    clip_params, make_optimizer)

Params = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The JAX ``TrainState``'s fields: ``disc_opt`` is ``{}`` for a mode
    without a discriminator (JAX ``()``), ``step`` a Python int."""
    params: Params
    gen_opt: dict
    disc_opt: dict
    step: int


def make_train_step(model):
    """``(step, init_state)``; k is ``model.cfg.critic_iters``.

    ``step(state, raw_batches, do_gen, generator=None, noise=None)`` updates
    ``state`` in place and returns ``(state, metrics)``: ``raw_batches`` is
    [1 + k, B, ...] raw inputs; ``noise`` optionally maps draw names to
    tensors to use in place of draws from ``generator``, stacked over the
    iteration's updates: [1 + k, ...] (update 0 is G's), except the draws
    only a D update makes (``model.DISC_ONLY_DRAWS``, e.g. ``"alpha"``
    [k, B, 1]), stacked over the k D updates. The metrics are device
    scalars.
    """
    cfg = model.cfg
    if int(cfg.accum_steps or 1) > 1:
        raise NotImplementedError(
            "accum_steps > 1: gradient accumulation comes in a later slice "
            "of the port")
    if cfg.remat:
        raise NotImplementedError(
            "remat: rematerialization comes in a later slice of the port")
    if cfg.fused_gp:
        raise NotImplementedError(
            "fused_gp: the batched wali-gp penalty (an opt-in the JAX "
            "package measured slower) comes in a later slice of the port")
    if cfg.decay:
        raise NotImplementedError(
            "decay: the linear learning-rate decay comes in a later slice of "
            "the port")
    k = cfg.critic_iters
    gen_spec, disc_spec = model.opt_specs()
    param_dtype = getattr(torch, cfg.param_dtype)
    low_byte = param_dtype != torch.float32
    moment_dtype = None if cfg.moment_dtype == "float32" \
        else getattr(torch, cfg.moment_dtype)
    opt_kw = dict(master_weights=low_byte, moment_dtype=moment_dtype)
    gen_opt = make_optimizer(gen_spec, **opt_kw)
    disc_opt = make_optimizer(disc_spec, **opt_kw) \
        if disc_spec is not None else None
    gen_names, disc_names = model.GEN_PLAYER, model.DISC_PLAYER

    def init_state(params: Params) -> TrainState:
        if low_byte:
            params = {n: p.to(param_dtype) if p.is_floating_point() else p
                      for n, p in params.items()}
        gen_params, _ = partition(params, gen_names)
        disc_params, _ = partition(params, disc_names)
        return TrainState(
            params=dict(params), gen_opt=gen_opt.init(gen_params),
            disc_opt=disc_opt.init(disc_params) if disc_opt else {}, step=0)

    def update(state, names, opt, opt_state, loss_fn, clip=None):
        player, _ = partition(state.params, names)
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in player.items()}
        loss, _ = loss_fn(merge(state.params, leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        opt.update(dict(zip(leaves, grads)), opt_state, player)
        if clip is not None:
            # wali: clip every D parameter after its update
            # (tflib/objs/gan_inference.py:15-24); the f32 masters too, or
            # they drift outside the box
            clip_params(player, clip, "Discriminator")
            if "master" in opt_state:
                clip_params(opt_state["master"], clip, "Discriminator")
        return loss.detach()

    def step(state: TrainState, raw_batches: torch.Tensor, do_gen: bool,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        def draws(j):
            """Update j's draws: 0 is the G update, 1 + i D update i."""
            if noise is None:
                return None
            disc_only = model.DISC_ONLY_DRAWS
            return {n: t[j - 1] if n in disc_only else t[j]
                    for n, t in noise.items() if j or n not in disc_only}

        metrics: Dict[str, torch.Tensor] = {}
        if do_gen:
            metrics["gen_cost"] = update(
                state, gen_names, gen_opt, state.gen_opt,
                lambda p: model.gen_loss(p, raw_batches[0],
                                         generator=generator,
                                         draws=draws(0)))
        else:
            with torch.no_grad():
                metrics["gen_cost"], _ = model.gen_loss(
                    state.params, raw_batches[0], generator=generator,
                    draws=draws(0))
        if disc_opt is not None:
            for i in range(k):
                metrics["disc_cost"] = update(
                    state, disc_names, disc_opt, state.disc_opt,
                    lambda p: model.disc_loss(p, raw_batches[1 + i],
                                              generator=generator,
                                              draws=draws(1 + i)),
                    disc_spec.weight_clip)
        state.step += 1
        return state, metrics

    return step, init_state
