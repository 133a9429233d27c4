"""The port's determinism audit (graphical_gan_tpu_torch/tools/
determinism.py) on the CPU: all five checks pass for each family at a
tiny width, the comparators catch an injected divergence and an injected
reorder (as the JAX package's tests inject them), ``_bit_equal`` judges
pairs as JAX's does, and the CLI refuses to run without a card.
"""

import json

import numpy as np
import pytest
import torch

from graphical_gan_tpu.tools import determinism as jax_det
from graphical_gan_tpu_torch.tools import determinism as det
from _torch_threads import one_thread  # noqa: F401

CHECKS = ["step_replay", "chunk_replay", "loader_replay", "prefetch_order",
          "trainer_replay"]


@pytest.mark.parametrize("family, dim, batch_size", [
    ("gan", 8, 8), ("gmgan", 8, 8), ("ssgan", 4, 2)])
def test_audit_all_checks_pass(family, dim, batch_size):
    results = det.run_all(family, dim=dim, batch_size=batch_size,
                          chunk_iters=2, trainer_iters=3, device="cpu")
    assert [r["check"] for r in results] == CHECKS
    bad = [r for r in results if not r["ok"]]
    assert not bad, bad


def test_cli_prints_five_lines(capsys):
    rc = det.main(["--family", "gmgan", "--dataset", "mnist", "--dim", "4",
                   "--batch-size", "4", "--chunk-iters", "1",
                   "--trainer-iters", "2", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["check"] for r in lines] == CHECKS
    assert all(r["ok"] and r["family"] == "gmgan" and r["backend"] == "cpu"
               and r["device_kind"] == "cpu" for r in lines)


def test_loader_replay_detects_seed_divergence(monkeypatch):
    from graphical_gan_tpu_torch.data import common

    orig = common.generator_factory
    calls = {"n": 0}

    def skewed(batch_size, *arrays, seed=None):
        calls["n"] += 1
        return orig(batch_size, *arrays,
                    seed=seed + (calls["n"] - 1))  # 2nd replay re-seeded

    monkeypatch.setattr(common, "generator_factory", skewed)
    r = det.check_loader_replay()
    assert not r["ok"]
    assert "differs" in r["detail"]


def test_prefetch_order_detects_reorder(monkeypatch):
    from graphical_gan_tpu_torch.data import prefetch as pf

    orig = pf.prefetch_to_device

    def reordering(iterator, size=2, device="cuda"):
        items = list(iterator)
        items[0], items[1] = items[1], items[0]
        return orig(iter(items), size=size, device=device)

    monkeypatch.setattr(pf, "prefetch_to_device", reordering)
    r = det.check_prefetch_order("cpu")
    assert not r["ok"]
    assert "out of order" in r["detail"]


BIT_EQUAL_CASES = {
    "nan_equals_nan": ({"x": np.array([1.0, np.nan])},
                       {"x": np.array([1.0, np.nan])}),
    "value_differs": ({"x": np.array([1.0, np.nan])},
                      {"x": np.array([1.0, 2.0])}),
    "shape_differs": ({"x": np.array([1.0, np.nan])},
                      {"x": np.array([[1.0, np.nan]])}),
    "leaf_missing": ({"x": np.zeros(2), "y": np.zeros(1)},
                     {"x": np.zeros(2)}),
    "negative_zero": ({"x": np.array([0.0])}, {"x": np.array([-0.0])}),
}


@pytest.mark.parametrize("case", sorted(BIT_EQUAL_CASES))
def test_bit_equal_as_jax(case):
    a, b = BIT_EQUAL_CASES[case]
    got = det._bit_equal({k: torch.from_numpy(v) for k, v in a.items()},
                         {k: torch.from_numpy(v) for k, v in b.items()})
    assert got == jax_det._bit_equal(a, b)


def test_bit_equal_reads_bf16_and_state_trees():
    a = torch.tensor([1.5, float("nan")], dtype=torch.bfloat16)
    assert det._bit_equal([a, 3], [a.clone(), 3])
    assert not det._bit_equal([a, 3], [a.clone(), 4])


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        det.main(["--family", "gan", "--dim", "8"])
