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
passes them in (the names are the model's, ``models/gan_inference.py``,
``models/gmgan.py``).

The options of the JAX step:

- ``accum_steps = a > 1`` (``accumulate_value_and_grad``, JAX ``:38-96``):
  each update's batch splits into a microbatches, run one after another,
  each with its own draws; the losses and gradients are summed in f32,
  scaled by 1/a and cast back to each leaf's dtype, and the optimizer makes
  one update. Batch-coupled terms (batch-statistics BN) see microbatch
  statistics, as in JAX. A batch that a does not divide raises.
- ``remat``: each player's loss runs under ``torch.utils.checkpoint``
  (non-reentrant), as JAX wraps both losses in ``jax.checkpoint``: the
  backward recomputes the forward. The checkpoint restores only the
  default generators' states before it recomputes, so the step restores
  its own ``torch.Generator`` too: the recompute draws what the forward
  drew, and the gradients are those without remat, bit for bit. A loss
  that differentiates inside its forward (wali-gp's penalty) unpacks the
  checkpointed tensors there, so it runs three times per update, not two.
- ``lr_scale(t)`` scales Adam's step size at its step count t
  (``optim/optimizers.py``; ``runs/gan_inference.py`` passes the linear
  decay when ``cfg.decay`` is set).
- ``fused_gp`` is the model's (``models/gan_inference.py``).

A raw batch is a tensor or a dict of tensors (SSGAN's ``{'x', 'y'}``),
each leaf [1 + k, B, ...]; ``core/tree.py`` indexes, splits and places
both forms alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from graphical_gan_tpu_torch.core import tree
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


def _rematerialized(loss_fn, generator: Optional[torch.Generator]):
    """``loss_fn`` under a non-reentrant checkpoint whose recompute draws
    from ``generator`` what the forward drew: its state at the forward is
    set again for the recompute, and the state the stream has reached is
    put back after it."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(params):
        if start is None or not calls:
            calls.append(True)
            return loss_fn(params)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return loss_fn(params)
        finally:
            generator.set_state(now)

    return lambda params: checkpoint(run, params, use_reentrant=False)


def make_train_step(model, lr_scale: Optional[Callable[[float], float]]
                    = None, sync=None):
    """``(step, init_state)``; k is ``model.cfg.critic_iters``.

    ``step(state, raw_batches, do_gen, generator=None, noise=None)`` updates
    ``state`` in place and returns ``(state, metrics)``: ``raw_batches`` is
    [1 + k, B, ...] raw inputs; ``noise`` optionally maps draw names to
    tensors to use in place of draws from ``generator``, stacked over the
    iteration's updates: [1 + k, ...] (update 0 is G's), except the draws
    only a D update makes (``model.DISC_ONLY_DRAWS``, e.g. ``"alpha"``
    [k, B, 1]), stacked over the k D updates. With ``accum_steps = a > 1``
    each has a microbatch axis after the update axis, [1 + k, a, ...] (or
    [k, a, ...]), ``...`` the draw's shape at B / a rows; at iteration 0
    (``do_gen`` False) the G loss is then the mean over the microbatches,
    where the JAX step evaluates it once on the whole batch. The metrics
    are device scalars.

    ``sync`` (``parallel/mesh.py``, one rank of a parallel step) averages
    each update's gradients over the ranks that hold the batch's other
    rows, ``sync.grads(list) -> list``, before the optimizer reads them,
    and each cost, ``sync.loss(t) -> t``.
    """
    cfg = model.cfg
    k = cfg.critic_iters
    accum = int(getattr(cfg, "accum_steps", 1) or 1)
    if accum > 1 and cfg.batch_size % accum:
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                         f"accum_steps={accum}")
    remat = bool(getattr(cfg, "remat", False))
    gen_spec, disc_spec = model.opt_specs()
    param_dtype = getattr(torch, cfg.param_dtype)
    low_byte = param_dtype != torch.float32
    moment_dtype = None if cfg.moment_dtype == "float32" \
        else getattr(torch, cfg.moment_dtype)
    opt_kw = dict(lr_scale=lr_scale, master_weights=low_byte,
                  moment_dtype=moment_dtype)
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

    def value_and_grad(loss_fn, params, leaves, generator):
        """(loss, grads) of one microbatch's loss w.r.t. ``leaves``."""
        if remat:
            loss_fn = _rematerialized(loss_fn, generator)
        loss, _ = loss_fn(merge(params, leaves))
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    def update(state, names, opt, opt_state, loss_of, raw, draws, generator,
               clip=None):
        """One optimizer update of a player: ``loss_of(params, raw,
        draws)`` over the whole batch or, accumulated, its microbatches."""
        player, _ = partition(state.params, names)
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in player.items()}
        if accum == 1:
            loss, grads = value_and_grad(
                lambda p: loss_of(p, raw, draws), state.params, leaves,
                generator)
        else:
            loss = torch.zeros((), device=tree.device(raw))
            sums = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves.values()]
            for j, raw_j in enumerate(tree.chunk(raw, accum)):
                draws_j = None if draws is None else {
                    n: t[j] for n, t in draws.items()}
                loss_j, grads_j = value_and_grad(
                    lambda p: loss_of(p, raw_j, draws_j), state.params,
                    leaves, generator)
                loss = loss + loss_j.detach().float()
                torch._foreach_add_(sums, [g.float() for g in grads_j])
            loss = loss * (1.0 / accum)
            torch._foreach_mul_(sums, 1.0 / accum)
            grads = [s.to(p.dtype) for s, p in zip(sums, leaves.values())]
        if sync is not None:
            grads = sync.grads(list(grads))
            loss = sync.loss(loss.detach())
        opt.update(dict(zip(leaves, grads)), opt_state, player)
        if clip is not None:
            # wali: clip every D parameter after its update
            # (tflib/objs/gan_inference.py:15-24); the f32 masters too, or
            # they drift outside the box
            clip_params(player, clip, "Discriminator")
            if "master" in opt_state:
                clip_params(opt_state["master"], clip, "Discriminator")
        return loss.detach()

    def step(state: TrainState, raw_batches, do_gen: bool,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        def draws(j):
            """Update j's draws: 0 is the G update, 1 + i D update i."""
            if noise is None:
                return None
            disc_only = model.DISC_ONLY_DRAWS
            return {n: t[j - 1] if n in disc_only else t[j]
                    for n, t in noise.items() if j or n not in disc_only}

        def gen_loss(p, raw, d):
            return model.gen_loss(p, raw, generator=generator, draws=d)

        def disc_loss(p, raw, d):
            return model.disc_loss(p, raw, generator=generator, draws=d)

        metrics: Dict[str, torch.Tensor] = {}
        if do_gen:
            metrics["gen_cost"] = update(
                state, gen_names, gen_opt, state.gen_opt, gen_loss,
                tree.index(raw_batches, 0), draws(0), generator)
        elif accum == 1:
            with torch.no_grad():
                metrics["gen_cost"], _ = gen_loss(
                    state.params, tree.index(raw_batches, 0), draws(0))
        else:
            d0 = draws(0)
            with torch.no_grad():
                metrics["gen_cost"] = sum(
                    gen_loss(state.params, raw_j, None if d0 is None else
                             {n: t[j] for n, t in d0.items()})[0].float()
                    for j, raw_j in enumerate(
                        tree.chunk(tree.index(raw_batches, 0), accum))
                ) * (1.0 / accum)
        if sync is not None and not do_gen:
            metrics["gen_cost"] = sync.loss(metrics["gen_cost"])
        if disc_opt is not None:
            for i in range(k):
                metrics["disc_cost"] = update(
                    state, disc_names, disc_opt, state.disc_opt, disc_loss,
                    tree.index(raw_batches, 1 + i), draws(1 + i), generator,
                    disc_spec.weight_clip)
        state.step += 1
        return state, metrics

    return step, init_state
