"""The pipeline's staged costs of family 1 (``graphical_gan_tpu_torch/
parallel/pipeline.py: sequential_staged_losses``) against the JAX
package's, from the same parameters, batch and per-(stage, microbatch)
draws, at dim 8, B 8 and 2 microbatches: both players' costs and their
gradients through every stage function of the 2-stage player cut (ali;
wali-gp, whose gradient penalty stays in the last stage) and of the
4-stage conv-trunk cut (cifar10 ali). Tolerances:
``tests/_torch_pipeline.py: check_staged_losses``.
"""

import pytest

from _torch_pipeline import check_staged_losses
from _torch_threads import one_thread  # noqa: F401

CASES = {"cifar10-ali-2": ("cifar10", "ali", 2),
         "cifar10-wali-gp-2": ("cifar10", "wali-gp", 2),
         "cifar10-ali-4": ("cifar10", "ali", 4)}


@pytest.mark.parametrize("name", list(CASES))
def test_staged_losses_and_grads_match_jax(name):
    dataset, mode, n_stages = CASES[name]
    check_staged_losses("gan", dataset, mode, n_stages)
