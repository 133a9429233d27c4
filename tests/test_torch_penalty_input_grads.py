"""The gradient penalty's inner pass computes D's input gradients only
(``objectives/penalties.py`` opens ``ops/kernels/fused_conv.py:
input_grads_only`` around its ``torch.autograd.grad(..., create_graph=
True)``), on the CPU at dim 8, B 4:

- every ``aten.convolution_backward`` dispatched inside that scope has its
  weight-gradient mask false, in the plain wali-gp step, under ``remat``
  (whose recompute runs the penalty again inside the outer backward), under
  ``fused_gp``, on mnist's D with batch-statistics BN, and for the general
  ``gradient_penalty``;
- the step's outputs (every leaf of the state, and the costs) equal the
  former formulation's bit for bit: that formulation is rebuilt here by a
  monkeypatch (no scope, and K1's backward handing ``convolution_backward``
  the layer's input undetached, as it did before), and the port has no
  switch for it.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.objectives import penalties
from graphical_gan_tpu_torch.ops.activations import activation_grad
from graphical_gan_tpu_torch.ops.kernels import fused_conv
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from graphical_gan_tpu_torch.train.step import make_train_step
from _torch_threads import one_thread  # noqa: F401

KW = dict(dim=8, batch_size=4)


class _Masks(TorchDispatchMode):
    """(inside the scope, weight mask) of each convolution_backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func.overloadpacket) == "aten.convolution_backward":
            self.calls.append((getattr(fused_conv._scope, "input_only",
                                       False), bool(args[10][1])))
        return func(*args, **(kwargs or {}))


def _former_backward(g, x, w, y, stride, padding, act, needs):
    """K1's backward as it was: x reaches ``convolution_backward`` with its
    graph whatever the mask."""
    kh, kw = w.shape[:2]
    (plo, phi), (qlo, qhi) = fused_conv._pads(x.shape[1], x.shape[2], kh,
                                              kw, stride, padding)
    gz = (g.float() * activation_grad(act, y.float())).to(x.dtype)
    dx = dw = dbias = None
    if needs[0] or needs[1]:
        xp = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            gz.permute(0, 3, 1, 2), xp, w.to(x.dtype).permute(3, 2, 0, 1),
            None, [stride, stride], [0, 0], [1, 1], False, [0, 0], 1,
            [bool(needs[0]), bool(needs[1]), False])
        if needs[0]:
            h, wd = x.shape[1], x.shape[2]
            dx = dxp[:, :, plo:plo + h, qlo:qlo + wd].permute(0, 2, 3, 1)
        if needs[1]:
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
    if needs[2]:
        dbias = gz.float().sum(dim=(0, 1, 2))
    return dx, dw, dbias


def _former(monkeypatch):
    class _NoScope:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(penalties, "input_grads_only", _NoScope)
    monkeypatch.setattr(fused_conv, "conv2d_bias_act_backward",
                        _former_backward)


def _step(dataset, **overrides):
    """Two iterations of the wali-gp step from one seed: (state leaves,
    costs, convolution_backward calls)."""
    cfg = gan_inference_defaults(dataset, "wali-gp", critic_iters=2, **KW,
                                 **overrides)
    model = GanInferenceModel(cfg)
    step, init = make_train_step(model)
    state = init(model.init(3, "cpu"))
    rng = np.random.default_rng(4)
    shape = (2, 1 + cfg.critic_iters, cfg.batch_size, cfg.data.output_dim)
    raw = torch.from_numpy(rng.random(shape, dtype=np.float32) if
                           cfg.data.normalization == "unit" else
                           rng.integers(0, 256, shape).astype(np.float32))
    gen = torch.Generator()
    costs = []
    with _Masks() as masks:
        for it in range(2):
            gen.manual_seed(10 + it)
            state, met = step(state, raw[it], it > 0, gen)
            costs.append({k: float(v) for k, v in met.items()})
    leaves = {k: v.detach().clone()
              for k, v in ckpt_lib.state_leaves(state).items()}
    return leaves, costs, masks.calls


CASES = {"cifar10 plain": ("cifar10", {}),
         "cifar10 remat": ("cifar10", {"remat": True}),
         "cifar10 fused_gp": ("cifar10", {"fused_gp": True}),
         "mnist BN in D": ("mnist", {})}


@pytest.mark.parametrize("case", list(CASES))
def test_inner_pass_asks_for_no_weight_gradient(case, monkeypatch):
    dataset, overrides = CASES[case]
    leaves, costs, calls = _step(dataset, **overrides)
    inner = [w for scoped, w in calls if scoped]
    outer = [w for scoped, w in calls if not scoped]
    assert inner and not any(inner)
    # the outer backward still takes the filters' gradients
    assert any(outer)

    _former(monkeypatch)
    old_leaves, old_costs, old_calls = _step(dataset, **overrides)
    assert not any(scoped for scoped, _ in old_calls)
    # the former pass asked for D's weight gradients where the repaired
    # one does not, and ran more convolution_backward calls
    assert sum(w for _, w in old_calls) > sum(w for _, w in calls)
    assert costs == old_costs
    assert set(leaves) == set(old_leaves)
    for key, leaf in old_leaves.items():
        assert torch.equal(leaves[key], leaf), key


def test_general_penalty_asks_for_no_weight_gradient():
    """``gradient_penalty`` over a conv D on (x, z) interpolates."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 5, 3, 8)).astype(
        np.float32) * 0.1).requires_grad_(True)
    bias = torch.zeros(8, requires_grad=True)

    def d_fn(x, z):
        h = fused_conv.conv2d_bias_act(x.contiguous(), w, bias, 2, "SAME",
                                       "leaky_relu")
        return h.flatten(1).sum(1) + z.square().sum(1)

    reals = [torch.from_numpy(rng.standard_normal((4, 8, 8, 3)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal((4, 6)).astype(
            np.float32))]
    fakes = [r + 1.0 for r in reals]
    alpha = torch.from_numpy(rng.random((4, 1, 1, 1)).astype(np.float32))
    with _Masks() as masks:
        gp = penalties.gradient_penalty(d_fn, reals, fakes, alpha,
                                        slope_argnums=(0, 1))
        gw, = torch.autograd.grad(gp, [w])
    assert masks.calls[0] == (True, False)
    # the outer pass differentiates the input gradient w.r.t. the filter
    assert np.isfinite(gw.numpy()).all() and float(gw.abs().max()) > 0
    assert not getattr(fused_conv._scope, "input_only", False)
