"""Per-player optimizers with TF1's update rules
(``graphical_gan_tpu/optim/optimizers.py``).

- TF1 Adam folds the bias correction into the step size,
  ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, and adds eps outside the
  square root: ``p -= lr_t * m / (sqrt(v) + eps)``.
- TF1 RMSProp starts its second moment at ones (not zeros), decay 0.9,
  eps 1e-10: ``ms = .9 ms + .1 g^2; p -= lr * g / sqrt(ms + eps)``.

The state keeps the JAX package's structure, so a checkpoint carries over
both ways: Adam ``{"m": {name: t}, "v": {...}, "t": int32}``, RMSProp
``{"ms": {...}}``, and with ``master_weights`` an f32 ``"master"`` copy of
the (then low-precision) live parameters. ``moment_dtype`` stores the
moments narrower; the update arithmetic runs in f32 either way.

``update`` works **in place**, under ``torch.no_grad()``: it overwrites the
moments and the parameter tensors it is given (multi-tensor ``_foreach``
ops, a few launches per player instead of a few per tensor), where the JAX
functions return new arrays. Adam's step count ``t`` is a CPU tensor, so
``lr_t`` is computed on the host and the update never waits on the card.
The update reads ``lr_t`` from a device scalar, in JAX's order, ``p -
lr_t * m / (sqrt(v) + eps)`` (``optimizers.py:85``): the train step
counts ``t`` on the host before an iteration and fills the step sizes of
its updates into one small device tensor (:meth:`Adam.advance`), so a
CUDA graph of the iteration (``train/graph.py``) reads new step sizes at
each replay; an update given no scalar counts ``t`` and makes its own.
Adam's
``lr_scale(t)`` scales ``lr_t`` at that optimizer's own step count ``t``
(1 at its first update), as the JAX Adam does (``optimizers.py: 41,
73-74``): the face script's linear decay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from graphical_gan_tpu_torch.objectives.common import OptSpec

Params = Dict[str, torch.Tensor]


def _f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """f32 views of ``ts``: the tensors themselves where they are f32 (so
    in-place ops update them), f32 copies otherwise."""
    return [t.float() for t in ts]


def _store(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """Write the f32 results back into tensors that were copied by _f32."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


@dataclass(frozen=True)
class _Base:
    master_weights: bool = False
    moment_dtype: Optional[torch.dtype] = None

    def _moments(self, params: Params, fill: float) -> Params:
        md = self.moment_dtype or torch.float32
        return {n: torch.full(p.shape, fill, dtype=md, device=p.device)
                for n, p in params.items()}

    def _with_master(self, state: dict, params: Params) -> dict:
        if self.master_weights:
            state["master"] = {n: p.detach().float().clone()
                               for n, p in params.items()}
        return state

    def _base(self, state: dict, params: Params, names):
        """(the f32 tensors the update writes, the live parameters)."""
        live = [params[n] for n in names]
        if self.master_weights:
            return [state["master"][n] for n in names], live
        return _f32(live), live


@dataclass(frozen=True)
class Adam(_Base):
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    lr_scale: Optional[Callable[[float], float]] = None

    def init(self, params: Params) -> dict:
        return self._with_master(
            {"m": self._moments(params, 0.0), "v": self._moments(params, 0.0),
             "t": torch.zeros((), dtype=torch.int32)}, params)

    def lr_t(self, t: int) -> float:
        """The bias-corrected step size at step ``t``, times ``lr_scale(t)``
        where there is one, in f32 arithmetic as the JAX update computes
        it."""
        f = np.float32
        lr_t = f(self.lr) * np.sqrt(f(1.0) - f(self.beta2) ** f(t)) \
            / (f(1.0) - f(self.beta1) ** f(t))
        if self.lr_scale is not None:
            lr_t = f(lr_t) * f(self.lr_scale(f(t)))
        return float(lr_t)

    def advance(self, state: dict, n: int) -> List[float]:
        """Count ``n`` updates in ``state``'s ``t`` (a CPU int32) and return
        their step sizes, ``lr_t`` at each of their counts."""
        state["t"] = state["t"] + n
        t = int(state["t"])
        return [self.lr_t(t - n + i) for i in range(1, n + 1)]

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params,
               lr_t: Optional[torch.Tensor] = None) -> None:
        """One update at step size ``lr_t``, an f32 scalar on the
        parameters' device that the caller filled from :meth:`advance`;
        without it the update counts ``t`` and makes the scalar itself."""
        names = list(grads)
        if lr_t is None:
            lr_t = torch.full((), self.advance(state, 1)[0],
                              dtype=torch.float32,
                              device=params[names[0]].device)
        g = _f32([grads[n] for n in names])
        ms, vs = [state["m"][n] for n in names], [state["v"][n] for n in names]
        m, v = _f32(ms), _f32(vs)
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1.0 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        base, live = self._base(state, params, names)
        step = torch._foreach_mul(m, lr_t)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(base, step)
        _store(live, base)
        _store(ms, m)
        _store(vs, v)


@dataclass(frozen=True)
class RMSProp(_Base):
    lr: float = 1e-3
    decay: float = 0.9
    eps: float = 1e-10

    def init(self, params: Params) -> dict:
        return self._with_master({"ms": self._moments(params, 1.0)}, params)

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params) -> None:
        names = list(grads)
        g = _f32([grads[n] for n in names])
        mss = [state["ms"][n] for n in names]
        ms = _f32(mss)
        torch._foreach_mul_(ms, self.decay)
        torch._foreach_addcmul_(ms, g, g, value=1.0 - self.decay)
        denom = torch._foreach_add(ms, self.eps)
        torch._foreach_sqrt_(denom)
        base, live = self._base(state, params, names)
        torch._foreach_addcdiv_(base, g, denom, value=-self.lr)
        _store(live, base)
        _store(mss, ms)


def make_optimizer(spec: OptSpec,
                   lr_scale: Optional[Callable[[float], float]] = None,
                   master_weights: bool = False,
                   moment_dtype: Optional[torch.dtype] = None):
    """The optimizer an ``OptSpec`` names (``optimizers.py:137-148``);
    ``lr_scale`` reaches Adam only, as in JAX."""
    kw = dict(master_weights=master_weights, moment_dtype=moment_dtype)
    if spec.kind == "adam":
        return Adam(lr=spec.lr, beta1=spec.beta1, beta2=spec.beta2,
                    eps=spec.eps, lr_scale=lr_scale, **kw)
    if spec.kind == "rmsprop":
        return RMSProp(lr=spec.lr, **kw)
    raise ValueError(f"unknown optimizer kind {spec.kind!r}")


@torch.no_grad()
def clip_params(params: Params, bound: float, name_filter: str = "") -> None:
    """Clip, in place, every parameter whose name contains ``name_filter``
    to [-bound, bound] (``tflib/objs/gan_inference.py:15-24``)."""
    for n, p in params.items():
        if name_filter in n:
            p.clamp_(-bound, bound)
