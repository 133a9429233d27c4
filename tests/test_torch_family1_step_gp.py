"""The port's alternating step against the JAX ``make_train_step`` where a
penalty or a new network sits in it: mnist ``wali-gp`` (the penalty's
double backward through D's two BNs, k = 2 here for time) and celeba
``ali`` (four-stage nets, the dequantization noise passed in), 3
iterations at dim 8, B 4, f32, from the same parameters, batches and
draws. The tolerances are stated in ``tests/_torch_family1.py:
check_states``.
"""

import pytest

from _torch_family1 import check_states, run_steps


@pytest.mark.parametrize("dataset,mode,k", [("mnist", "wali-gp", 2),
                                            ("celeba", "ali", 1)])
def test_three_iterations_match_jax_step(dataset, mode, k):
    js, ts, costs = run_steps(dataset, mode, critic_iters=k)
    check_states(js, ts, costs, k)
