"""Expert parallelism of the port (``graphical_gan_tpu_torch/parallel/
expert.py``) on 2 gloo ranks on the CPU: GMGAN mnist local_ep with 6
components on a ``(data 1, expert 2)`` mesh, CONCRETE (the Gumbel noise
drawn whole and split, the softmax's max and sum over the ranks) against
JAX's own EP mesh step on the same mesh of virtual CPU devices, and it
and STRAIGHT_THROUGHT (the argmax over the ranks) against the port's
one-process step (tolerances: ``tests/_torch_parallel.py``). Each rank
holds 3 of the 6 rows of ``Generator.Hyper.Mu`` and of its Adam moments;
the rest is replicated bit for bit. n_coms that the group does not divide
keeps Mu whole, as in JAX.
"""

import numpy as np
import pytest

from _torch_parallel import check_against, check_replicas, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401

MU = "Generator.Hyper.Mu"
CASES = ["CONCRETE", "STRAIGHT_THROUGHT"]


@pytest.fixture(scope="module")
def runs():
    cases = [prepare("gmgan", "mnist", "local_ep", "ep", (1, 2),
                     ("data", "expert"), with_jax=mk == "CONCRETE",
                     mode_k=mk, n_coms=6)
             for mk in CASES]
    return dict(zip(CASES, run_cases(cases, 2)))


def test_ep_matches_jax_mesh_step(runs):
    case, ranks = runs["CONCRETE"]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "jax")


@pytest.mark.parametrize("mode_k", CASES)
def test_ep_matches_one_process_step(runs, mode_k):
    case, ranks = runs[mode_k]
    check_against(case, ranks[0]["costs"], ranks[0]["full"], "port")


@pytest.mark.parametrize("mode_k", CASES)
def test_ep_ranks_hold_component_blocks(runs, mode_k):
    _, ranks = runs[mode_k]
    check_replicas(ranks)
    assert ranks[0]["sharded"] == [MU]
    blocks = [r["local"][f"params/{MU}"] for r in ranks]
    assert blocks[0].shape[0] == 3
    np.testing.assert_array_equal(np.concatenate(blocks),
                                  ranks[0]["full"][f"params/{MU}"])
    for slot in ("m", "v"):
        assert ranks[1]["local"][f"gen_opt/{slot}/{MU}"].shape[0] == 3


def test_non_dividing_components_keep_mu_whole():
    from graphical_gan_tpu_torch.parallel.expert import ep_param_shardings
    import torch

    class _M:
        shape = {"data": 1, "expert": 2}

    params = {MU: torch.zeros(5, 4), "Generator.Input.W": torch.zeros(4, 8)}
    assert ep_param_shardings(params, _M()) == {}
    params[MU] = torch.zeros(6, 4)
    assert ep_param_shardings(params, _M()) == {MU: ("expert", 0)}
