"""The port's GMGAN ``vegan`` mode (``graphical_gan_tpu_torch/models/
gmgan.py``) against the JAX package's ``GMGanModel`` on mnist, under each of
the four MODE_K: the code discriminator D(z, k) alone, z = 8, no BN, 5
critic updates per generator update.

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

MODE = "vegan"


@pytest.mark.parametrize("player", ["gen", "disc"])
@pytest.mark.parametrize("mode_k", MODE_KS)
def test_losses_and_gradients_match_jax(mode_k, player):
    check_losses("mnist", MODE, mode_k, player)


def test_two_iterations_match_jax_step():
    """At one critic update per generator update (the published 5 only
    repeats the D update; one keeps the JAX step's compile small)."""
    js, ts, costs = run_steps("mnist", MODE, "CONCRETE", critic_iters=1)
    check_states(js, ts, costs, 1, iters=2)
