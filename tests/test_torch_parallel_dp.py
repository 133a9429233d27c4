"""Data parallelism of the port (``graphical_gan_tpu_torch/parallel/
mesh.py``) on 2 gloo ranks on the CPU, against JAX's own DP mesh step on 2
of the virtual CPU devices and against the port's one-process step, from
the same parameters (``params_from_jax``), global raw batches and draws:
cifar10 wali-gp (the published mode at k = 1; the gradient penalty's double
backward, BN in E and G over the whole batch in K2a's and K2c+K2d's split
modes) and mnist vegan-kl (the aggregated posterior gathered over the
ranks, BN in the code D). Tolerances: ``tests/_torch_parallel.py``. The
replicas' parameters and Adam moments are the same bits on both ranks.
"""

import pytest

from _torch_parallel import check_against, check_replicas, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401

CASES = {"cifar10-wali-gp": ("gan", "cifar10", "wali-gp",
                             {"critic_iters": 1}),
         "mnist-vegan-kl": ("gan", "mnist", "vegan-kl", {})}


@pytest.fixture(scope="module")
def runs():
    cases = [prepare(fam, ds, mode, "dp", (2,), ("data",), **kw)
             for fam, ds, mode, kw in CASES.values()]
    return dict(zip(CASES, run_cases(cases, 2)))


@pytest.mark.parametrize("name", list(CASES))
def test_dp_matches_jax_mesh_step(runs, name):
    case, ranks = runs[name]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "jax")


@pytest.mark.parametrize("name", list(CASES))
def test_dp_matches_one_process_step(runs, name):
    case, ranks = runs[name]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "port")


@pytest.mark.parametrize("name", list(CASES))
def test_dp_replicas_bit_identical(runs, name):
    _, ranks = runs[name]
    assert [r["costs"] for r in ranks[1:]] == [ranks[0]["costs"]]
    check_replicas(ranks)


class _Mesh:
    """The two attributes ``shard_batch`` reads of rank 1 of a 2-rank
    data axis."""
    device = "cpu"

    def group(self, *axes):
        from graphical_gan_tpu_torch.parallel.collectives import Group
        return Group(None, 2, 1) if axes == ("data",) else None


def test_host_local_batches_are_the_rank_s_rows():
    """``parallel/input.py``: rank 1 of 2 keeps rows 2-3 of a global batch
    of 4, of a tensor and of a dict alike, and says which block it is."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.parallel.input import (
        global_batch_sharding, host_local_batches)
    x = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    got = host_local_batches(_Mesh(), x)
    assert torch.equal(got, torch.from_numpy(x[:, 2:4]))
    got = host_local_batches(_Mesh(), {"x": x, "y": x[..., :1]})
    assert torch.equal(got["y"], torch.from_numpy(x[:, 2:4, :1]))
    assert global_batch_sharding(_Mesh(), 3) == (1, 1, 2)
