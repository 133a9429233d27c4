"""The pipeline's staged costs of GMGAN (``graphical_gan_tpu_torch/
parallel/pipeline.py: build_gmgan_stages``) against the JAX package's
``sequential_staged_losses``, from the same parameters, batch and draws,
at dim 8, B 8, 5 components and 2 microbatches: local_ep with REINFORCE
(the score function reads stage 0's ``max q(k|x)`` across the boundary)
and ali with CONCRETE (the Gumbel draw of stage 0). Tolerances:
``tests/_torch_pipeline.py: check_staged_losses``.
"""

import pytest

from _torch_pipeline import check_staged_losses
from _torch_threads import one_thread  # noqa: F401

CASES = {"mnist-local_ep-REINFORCE": ("mnist", "local_ep", "REINFORCE"),
         "mnist-ali-CONCRETE": ("mnist", "ali", "CONCRETE")}


@pytest.mark.parametrize("name", list(CASES))
def test_gmgan_staged_losses_and_grads_match_jax(name):
    dataset, mode, mode_k = CASES[name]
    check_staged_losses("gmgan", dataset, mode, 2, mode_k=mode_k)
