"""The port's GMGAN ``local_ep`` mode (``graphical_gan_tpu_torch/models/
gmgan.py``) against the JAX package's ``GMGanModel`` on mnist, under each of
the four MODE_K: the paper's method, D(z, k) on the codes and D(x, z) on the
data, their CE costs averaged.

Each loss case runs one player's loss (G+E or D) through both frameworks
from the same parameters (the port's init, handed to JAX), raw batch and
random draws (JAX's, replayed from its registry stream and handed to the
port by name, ``tests/_torch_gmgan.py``), at dim 8, B 4, 5 components,
f32: the loss to atol 1e-4 of max(1, |ref|), each gradient leaf to 1e-4
of max(1e-2, its largest element, 1e-2 of the player's largest). Both
players of one MODE_K share one JAX compile. The step case runs 2
iterations of the JAX ``make_train_step`` and the port's (iteration 0
skips the G update), held as the family-1 step tests hold theirs
(``tests/_torch_family1.py: check_states``).
"""

import pytest

from _torch_family1 import check_states
from _torch_gmgan import check_losses, run_steps
from graphical_gan_tpu_torch.core.config import MODE_KS

MODE = "local_ep"


@pytest.mark.parametrize("player", ["gen", "disc"])
@pytest.mark.parametrize("mode_k", MODE_KS)
def test_losses_and_gradients_match_jax(mode_k, player):
    check_losses("mnist", MODE, mode_k, player)


def test_two_iterations_match_jax_step():
    js, ts, costs = run_steps("mnist", MODE, "CONCRETE")
    check_states(js, ts, costs, 1, iters=2)
