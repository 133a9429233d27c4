"""The card's 2-rank gate (``graphical_gan_tpu_torch/tools/
parallel_check.py: _misses``) on made-up states: past 1.25·lr it admits
only sign flips at small gradients (the parallel run's Adam m within
FLIP_M_SHARE of the leaf's largest reference m), on at most FLIP_SHARE of
a leaf, and refuses a flip at a large gradient, too many flips, a move
past the bound in the reference's direction and a cost off by more than
rtol 2e-4."""

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.tools import parallel_check as pc
from _torch_threads import one_thread  # noqa: F401

LR = 1e-4
N = 20000


class _Spec:
    lr = LR


class _Model:
    DISC_PLAYER = ("Discriminator",)

    class cfg:
        critic_iters = 5

    def opt_specs(self):
        return _Spec(), _Spec()


class _State:
    def __init__(self, w, m):
        self.params = {"Generator.W": w}
        self.gen_opt = {"m": {"Generator.W": m}}
        self.disc_opt = {}


def _after_one_update(g):
    """G's state after its one Adam update from 0 (about lr·sign(g))."""
    return _State(-LR * torch.sign(g), 0.5 * g)


def _case(kind):
    g = torch.from_numpy(np.random.RandomState(0).randn(N).astype(
        np.float32))
    order = torch.argsort(g.abs())
    got, costs = g.clone(), [{"gen_cost": 1.0}]
    if kind == "small flips":
        got[order[:5]] *= -1
    elif kind == "large flip":
        got[order[-1]] *= -1
    elif kind == "too many flips":
        got[order[:int(2 * pc.FLIP_SHARE * N)]] *= -1
    elif kind == "same sign, too far":
        ref, par = _after_one_update(g), _after_one_update(g)
        par.params["Generator.W"][order[-1]] *= 3.0
        return par, ref, costs
    elif kind == "cost":
        costs = [{"gen_cost": 1.0 + 1e-3}]
    return _after_one_update(got), _after_one_update(g), costs


@pytest.mark.parametrize("kind, admitted", [
    ("small flips", True), ("none", True), ("large flip", False),
    ("too many flips", False), ("same sign, too far", False),
    ("cost", False)])
def test_the_gate_admits_only_flips_at_small_gradients(kind, admitted):
    par, ref, costs = _case(kind)
    flips = {}
    misses = pc._misses(_Model(), costs, [{"gen_cost": 1.0}], par, ref,
                        {"Generator.W": torch.zeros(N)}, flips)
    assert (misses == []) == admitted, misses
    if kind == "small flips":
        rec = flips["params/Generator.W"]
        assert rec["n"] == 5 and rec["max_m_gap_share"] < pc.FLIP_M_SHARE


@pytest.mark.parametrize("m_max, per", [(None, 1.25), (1e-5, 1.25),
                                        (1e-9, 2.0)])
def test_update_bound(m_max, per):
    assert pc.update_bound(LR, 3, m_max, 1e-4) == pytest.approx(
        per * LR * 3)
