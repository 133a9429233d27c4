"""The port's SSGAN (``graphical_gan_tpu_torch/models/ssgan.py``) against
the JAX package's ``SSGanModel``: ali and alice-z under the ``concat_x``
video D.

The four SSGAN loss files together cover every pair of factors: each mode
with each video D, each mode and each video D with each of the four
pos_modes (``PLAN``), and the dataset (moving-MNIST conditional ``res`` /
chairs unconditional ``res_w``), LEN (4 / 3) and BN (off / on) turned with
the case (``tests/_torch_ssgan.py: cases``); every pos_mode under
``res`` and ``res_w`` is also held at the chain itself
(``test_torch_ssgan_model.py``).

One case runs one player's loss (G+E or D) through both frameworks from
the same parameters (the port's init, handed to JAX), raw batch and draws
(JAX's, replayed from its registry stream and handed to the port by name)
at the JAX tests' sizes (dim 4, dim_op 16, B 2, 64x64 frames), f32: the
loss to atol 1e-4 of max(1, |ref|), each gradient leaf to 1e-4 of
max(1e-2, its largest element, 1e-2 of the player's largest), and a bias
right before a BN, whose gradient is 0 in exact arithmetic, to 1e-5 of the
player's largest on each side. Both players of a config share one JAX
compile.
"""

import pytest

from _torch_ssgan import case_id, cases, check_losses

PLAN = [("ali", "naive_mean_field"), ("alice-z", "inverse"),
        ("ali", "forward_inverse"), ("alice-z", "gsp")]
CASES = cases(PLAN, ali_mode="concat_x")


@pytest.mark.parametrize("player", ["gen", "disc"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_losses_and_gradients_match_jax(case, player):
    dataset, mode, extra = case
    check_losses(dataset, mode, extra, player)
