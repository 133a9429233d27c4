"""The port's 4-stage pipeline step (the conv-trunk cut: Extractor trunk
| Extractor tail + Generator | Discriminator trunk | Discriminator tail)
on 4 gloo ranks on the CPU, cifar10 ali at dim 8, B 8, 2 microbatches, k
= 1, 2 iterations: against JAX's ``make_pp_train_step`` on 4 of the
virtual CPU devices and against the port's one-process staged step, from
the same parameters, batches and draws; activations and their gradients
cross three boundaries. Tolerances: ``tests/_torch_pipeline.py``.
"""

import pytest

from _torch_pipeline import check_against, check_ranks, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    case = prepare("gan", "cifar10", "ali", 4, critic_iters=1)
    return run_cases([case], 4)[0]


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_pp4_step_matches(run, ref):
    case, ranks = run
    check_against(case, ranks[0]["costs"], ranks[0]["state"], ref)


def test_pp4_ranks_hold_one_row_each_and_agree(run):
    check_ranks(*run)
