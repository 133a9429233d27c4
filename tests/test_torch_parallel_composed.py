"""Composed parallelism of the port (``graphical_gan_tpu_torch/parallel/
composed.py``) on 4 gloo ranks on the CPU: ``data 2 x model 2`` on cifar10
ali against JAX's own composed mesh step over the same mesh of virtual CPU
devices and against the port's one-process step, and ``seq 2 x model 2``
on SSGAN moving-MNIST local_ep (LEN 4, BN on) against the port's
one-process step (tolerances: ``tests/_torch_parallel.py``). The ranks of
one model coordinate hold the same slices bit for bit, and every rank's
gathered state is the same.
"""

import numpy as np
import pytest

from _torch_parallel import check_against, check_replicas, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401

CASES = {
    "data-model": ("gan", "cifar10", "ali", ("data", "model"), True, {}),
    "seq-model": ("ssgan", "moving_mnist", "local_ep", ("seq", "model"),
                  False, {"bn": True}),
}


@pytest.fixture(scope="module")
def runs():
    cases = [prepare(fam, ds, mode, "composed", (2, 2), axes,
                     with_jax=with_jax, **kw)
             for fam, ds, mode, axes, with_jax, kw in CASES.values()]
    return dict(zip(CASES, run_cases(cases, 4)))


def test_composed_data_model_matches_jax_mesh_step(runs):
    case, ranks = runs["data-model"]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "jax")


@pytest.mark.parametrize("name", list(CASES))
def test_composed_matches_one_process_step(runs, name):
    case, ranks = runs[name]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "port")


@pytest.mark.parametrize("name", list(CASES))
def test_composed_slices_agree_across_the_batch_group(runs, name):
    _, ranks = runs[name]
    first = ranks[0]
    for r in ranks[1:]:
        for key, v in first["full"].items():
            assert np.array_equal(v, r["full"][key]), (key, r["rank"])
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coords"]["model"], []).append(r)
    assert sorted(by_model) == [0, 1]
    for group in by_model.values():
        for r in group[1:]:
            for key, v in group[0]["local"].items():
                assert np.array_equal(v, r["local"][key]), (key, r["rank"])
    assert first["sharded"]
    check_replicas([by_model[0][0], by_model[1][0]])
