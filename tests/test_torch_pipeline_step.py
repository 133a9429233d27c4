"""The port's 2-stage pipeline step (``graphical_gan_tpu_torch/parallel/
pipeline.py: make_pp_train_step``) on 2 gloo ranks on the CPU, one stage
each, for 2 iterations at dim 8, B 8, 2 microbatches: cifar10 wali-gp
(k = 1) against JAX's own ``make_pp_train_step`` on 2 of the virtual CPU
devices and against the port's one-process staged step, from the same
parameters, batches and draws; GMGAN mnist local_ep with REINFORCE (k =
1) against the one-process staged step (its costs and gradients against
JAX's staged costs: ``test_torch_pipeline_losses_gmgan.py``). The players
are masked: each row's step count is its own player's updates, exactly.
Tolerances: ``tests/_torch_pipeline.py``.
"""

import pytest

from _torch_pipeline import check_against, check_ranks, prepare, run_cases
from _torch_threads import one_thread  # noqa: F401

CASES = {"cifar10-wali-gp": ("gan", "cifar10", "wali-gp",
                             {"critic_iters": 1}, True),
         "gmgan-mnist-local_ep": ("gmgan", "mnist", "local_ep",
                                  {"critic_iters": 1,
                                   "mode_k": "REINFORCE"}, False)}


@pytest.fixture(scope="module")
def runs():
    cases = [prepare(fam, ds, mode, 2, **kw)
             for fam, ds, mode, kw, _ in CASES.values()]
    out = run_cases(cases, 2, [c[-1] for c in CASES.values()])
    return dict(zip(CASES, out))


def test_pp_step_matches_jax_pp_step(runs):
    case, ranks = runs["cifar10-wali-gp"]
    check_against(case, ranks[0]["costs"], ranks[0]["state"], "jax")


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_one_process_staged_step(runs, name):
    case, ranks = runs[name]
    check_against(case, ranks[0]["costs"], ranks[0]["state"], "port")


@pytest.mark.parametrize("name", list(CASES))
def test_pp_ranks_hold_one_row_each_and_agree(runs, name):
    check_ranks(*runs[name])
