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


def _pp_rank(launches, misses=(), migration=None):
    rec = {"cases": [{"dataset": "cifar10", "mode": "wali-gp",
                      "misses": list(misses)}],
           "launches": dict(launches)}
    if migration is not None:
        rec["migration"] = migration
    return rec


K2_ALL = {k: 3 for k in pc.K2}


@pytest.mark.parametrize("change, missed", [
    (None, False), ("rank 1 no K1", True), ("rank 0 no K2", True),
    ("split launched", True), ("misses", True), ("migration", True)])
def test_misses_of_a_pipeline_run(change, missed):
    """The card's pipeline gate (``parallel_check.misses_of``): K1 on the
    ranks with convolutions, K2a/K2b/K2c+K2d on stage 0, no split kernel,
    no miss against the staged step, migration bit for bit."""
    r0 = dict(K2_ALL, fused_conv2d_bias_act=5)
    r1 = {"fused_conv2d_bias_act": 7}
    mig = {"cifar10": {"standard_pp_standard": True,
                       "pp_standard_pp": True}}
    misses = []
    if change == "rank 1 no K1":
        r1 = {}
    elif change == "rank 0 no K2":
        r0 = {"fused_conv2d_bias_act": 5}
    elif change == "split launched":
        r1["bn_stats_local"] = 1
    elif change == "misses":
        misses = ["params/x: 1 > 0"]
    elif change == "migration":
        mig["cifar10"]["pp_standard_pp"] = False
    doc = {"pp": [_pp_rank(r0, misses, mig), _pp_rank(r1)]}
    assert bool(pc.misses_of(doc, "cuda")) == missed
    # on the CPU the launches are not held (the plain versions run)
    if change in ("rank 1 no K1", "rank 0 no K2", "split launched"):
        assert pc.misses_of(doc, "cpu") == []


def _serve(err, share, launches):
    # the int8 dispatch's BNs write their int8 copies: the apply's int8 form
    int8 = {("bn_apply_split_q8" if k == "bn_apply_split" else k): v
            for k, v in launches.items()}
    return [{"cases": [dict(quantize=None, max_abs_err=err,
                            over_atol_share=0.0, launches=launches),
                       dict(quantize="int8", max_abs_err=1.0,
                            over_atol_share=share, launches=int8)]},
            {"cases": [{"served": 8}, {"served": 8}]}]


SPLIT_FWD = {"bn_stats_local": 3, "bn_apply_split": 3}


@pytest.mark.parametrize("err, share, launches, missed", [
    (0.0, 0.0, SPLIT_FWD, False),
    (2e-5, 0.0, SPLIT_FWD, True),
    (0.0, 2e-3, SPLIT_FWD, True),
    (0.0, 0.0, {"bn_stats": 1, "bn_apply": 1}, True),
    (0.0, 0.0, dict(SPLIT_FWD, bn_apply=3), True),
    (0.0, 0.0, dict(SPLIT_FWD, bn_stats_local=6), True)])
def test_misses_of_the_dp_server(err, share, launches, missed):
    """The dp server's gate: float within DP_SERVE_ATOL, int8 past it at
    most DP_SERVE_INT8_SHARE of the elements, the split forward launched
    (one ``bn_stats_local`` per ``bn_apply_split`` or int8 form) and never
    the one-launch K2a or K2b."""
    doc = {"serve": _serve(err, share, launches)}
    assert bool(pc.misses_of(doc, "cuda")) == missed


@pytest.mark.parametrize("b, m", [(64, 4), (50, 5), (8, 4), (6, 2), (7, 1)])
def test_microbatches(b, m):
    assert pc.microbatches(b) == m


def test_serve_run_on_the_cpu():
    """``--runs serve`` end to end on 2 gloo ranks on the CPU (small):
    the dp server's float and int8 dispatches equal one rank's."""
    doc = pc.main(["--device", "cpu", "--small", "--runs", "serve"])
    assert doc["misses"] == [] and set(doc) == {"serve", "misses"}
    cases = doc["serve"][0]["cases"]
    assert [c["quantize"] for c in cases] == [None, "int8"]
    assert all(c["dp_devices"] == 2 and c["shape"] == [8, 3072]
               for c in cases)


def _ranks(launches):
    case = {"strategy": "dp", "misses": [], "chunk_bit_identical": True,
            "replicas_bit_identical": True}
    return {"cases": [case], "launches": launches}


RANKS_SPLIT = {"bn_stats_local": 30, "bn_apply_split": 30,
               "bn_bwd_local": 10, "bn_bwd_apply_split": 10}


@pytest.mark.parametrize("launches, missed", [
    (RANKS_SPLIT, False),
    (dict(RANKS_SPLIT, bn_apply_split=0), True),
    (dict(RANKS_SPLIT, bn_stats_local=60), True),
    (dict(RANKS_SPLIT, bn_bwd_local=0), True),
    (dict(RANKS_SPLIT, bn_bwd_apply_split=20), True)])
def test_misses_of_the_ranks_split_launches(launches, missed):
    """The 2-rank training runs' gate: every split kernel launched, a
    split BN forward is one ``bn_stats_local`` and one ``bn_apply_split``
    and a split BN backward one ``bn_bwd_local`` and one
    ``bn_bwd_apply_split`` (as many of each); on the CPU the launches are
    not held."""
    doc = {"ranks": _ranks(launches)}
    assert bool(pc.misses_of(doc, "cuda")) == missed
    assert pc.misses_of(doc, "cpu") == []
