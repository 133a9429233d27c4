"""The alternating train step (``graphical_gan_tpu/train/step.py:98-251``).

One iteration is one G+E update (skipped at iteration 0, as the reference
does) and then k D updates, each on its own batch slice: slice 0 feeds the
G update and slice 1+i the i-th D update; ``disc_cost`` is the last D
update's loss. Each update differentiates its player's loss with respect to
that player's parameters only (``torch.autograd.grad`` on detached leaves),
so no gradient of the frozen player is computed, and the optimizer then
overwrites the parameters in place.

Where the JAX step is one jitted XLA program, this one runs on the port's
kernels in two parts: a host ``prologue`` (the step sizes of the
iteration's Adam updates written into one [1 + k] f32 device tensor, slot
0 the G update's and 1 + i the i-th D update's, then Adam's ``t`` and
``step`` counted on the host) and the device ``body`` (the draws, losses,
gradients and updates, which read their step sizes from that tensor). A
call runs both eagerly; the trainer's step graph (``train/graph.py``)
captures the body once and runs the prologue before each replay. A mode
without a discriminator (k = 0: vegan-mmd, -kl,
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
  (non-reentrant, the default generators left alone: every draw comes
  from the step's), as JAX wraps both losses in ``jax.checkpoint``: the
  backward recomputes the forward. The step rewinds its own
  ``torch.Generator`` for the recompute, so the recompute draws what the
  forward drew, and the gradients are those without remat, bit for bit.
  Under a CUDA graph's capture a generator's state can be neither read
  nor set, so there the recompute draws from a generator state of its
  own, registered with the graph and set by the host before each replay
  to the forward's seed and Philox offset (:class:`RematRewinds`). A loss
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
    Adam, clip_params, make_optimizer)

Params = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The JAX ``TrainState``'s fields: ``disc_opt`` is ``{}`` for a mode
    without a discriminator (JAX ``()``), ``step`` a Python int."""
    params: Params
    gen_opt: dict
    disc_opt: dict
    step: int


class RematRewinds:
    """Where remat's recomputes restart the step's generator, for the step
    graph (``train/graph.py``). ``offsets``, where not None, collects in
    order the Philox offset each recompute of an eager iteration restarts
    from (its forward's; the graph's warm-up); ``states``, where not None,
    holds in order one generator per recompute of the iteration being
    captured, registered with the graph and seeded at that offset before
    each replay, which the recompute draws from in place of the rewound
    generator."""

    def __init__(self):
        self.offsets: Optional[list] = None
        self.states: Optional[list] = None


def _rematerialized(loss_fn, generator: Optional[torch.Generator],
                    rewinds: RematRewinds):
    """``loss_fn`` under a non-reentrant checkpoint whose recompute draws
    from ``generator`` what the forward drew: its state at the forward is
    set again for the recompute, and the state the stream has reached is
    put back after it (under a capture, the recompute swaps in the next of
    ``rewinds.states`` instead)."""
    capturing = generator is not None and generator.device.type == "cuda" \
        and torch.cuda.is_current_stream_capturing()
    start = None if generator is None or capturing else generator.get_state()
    offset = generator.get_offset() if start is not None and \
        rewinds.offsets is not None else None
    calls = []

    def run(params):
        if generator is None or not calls:
            calls.append(True)
            return loss_fn(params)
        if capturing:
            if not rewinds.states:
                raise RuntimeError("remat: a recompute under capture that "
                                   "the warm-up iteration did not make")
            now = generator.graphsafe_get_state()
            generator.graphsafe_set_state(rewinds.states.pop(0))
            put_back = generator.graphsafe_set_state
        else:
            if offset is not None:
                rewinds.offsets.append(offset)
            now = generator.get_state()
            generator.set_state(start)
            put_back = generator.set_state
        try:
            return loss_fn(params)
        finally:
            put_back(now)

    return lambda params: checkpoint(run, params, use_reentrant=False,
                                     preserve_rng_state=False)


def make_train_step(model, lr_scale: Optional[Callable[[float], float]]
                    = None, sync=None):
    """``(step, init_state)``; k is ``model.cfg.critic_iters``.

    ``step(state, raw_batches, do_gen, generator=None, noise=None)`` updates
    ``state`` in place and returns ``(state, metrics)``; it is
    ``step.body(state, raw_batches, do_gen, generator, noise,
    step.prologue(state, do_gen))``. ``step.prologue(state, do_gen,
    out=None)`` writes the iteration's step sizes into ``out`` (a new
    tensor on the state's device where None) and returns it; it counts
    Adam's ``t`` and ``state.step``, which ``body`` leaves alone, so a
    captured body replays with the counts the host keeps;
    ``step.rewinds`` is remat's :class:`RematRewinds`. ``raw_batches`` is
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
    rewinds = RematRewinds()

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
            loss_fn = _rematerialized(loss_fn, generator, rewinds)
        loss, _ = loss_fn(merge(params, leaves))
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    def prologue(state: TrainState, do_gen: bool,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        sizes = [0.0] * (1 + k)
        if do_gen and isinstance(gen_opt, Adam):
            sizes[0] = gen_opt.advance(state.gen_opt, 1)[0]
        if k and isinstance(disc_opt, Adam):
            sizes[1:] = disc_opt.advance(state.disc_opt, k)
        state.step += 1
        if out is None:
            out = torch.empty(1 + k, dtype=torch.float32,
                              device=tree.device(state.params))
        # a pinned source is not reused before its copy has run
        cuda = out.device.type == "cuda"
        out.copy_(torch.tensor(sizes, dtype=torch.float32, pin_memory=cuda),
                  non_blocking=cuda)
        return out

    def update(state, names, opt, opt_state, loss_of, raw, draws, generator,
               lr_t, clip=None):
        """One optimizer update of a player: ``loss_of(params, raw,
        draws)`` over the whole batch or, accumulated, its microbatches;
        Adam's step size ``lr_t`` is a device scalar (ignored by
        RMSProp)."""
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
        opt.update(dict(zip(leaves, grads)), opt_state, player,
                   **({"lr_t": lr_t} if isinstance(opt, Adam) else {}))
        if clip is not None:
            # wali: clip every D parameter after its update
            # (tflib/objs/gan_inference.py:15-24); the f32 masters too, or
            # they drift outside the box
            clip_params(player, clip, "Discriminator")
            if "master" in opt_state:
                clip_params(opt_state["master"], clip, "Discriminator")
        return loss.detach()

    def body(state: TrainState, raw_batches, do_gen: bool,
             generator: Optional[torch.Generator],
             noise: Optional[Dict[str, torch.Tensor]],
             lr: torch.Tensor) -> Dict[str, torch.Tensor]:
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
                tree.index(raw_batches, 0), draws(0), generator, lr[0])
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
                    lr[1 + i], disc_spec.weight_clip)
        return metrics

    def step(state: TrainState, raw_batches, do_gen: bool,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        return state, body(state, raw_batches, do_gen, generator, noise,
                           prologue(state, do_gen))

    step.prologue, step.body, step.rewinds = prologue, body, rewinds
    return step, init_state
