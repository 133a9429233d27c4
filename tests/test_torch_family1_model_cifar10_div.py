"""The port's family-1 losses against the JAX package's on cifar10: the modes without a discriminator (VEGAN-mmd/-kl/-ikl/-jsd, VAE).

Each case runs one player's loss (G+E, or D where the mode has one) through
both frameworks from the same parameters (the port's init, handed to JAX),
raw batch and random draws (JAX's, replayed from its registry stream and
passed to the port by name), at dim 8, B 4, f32, and compares the loss and
its gradient w.r.t. that player's parameters. Tolerances
(``tests/_torch_family1.py``): the loss to atol 1e-4 of max(1, |ref|); each
gradient leaf to 1e-4 of max(1e-2, its largest element, 1e-2 of the
player's largest), f32 sums in other orders.
"""

import pytest

from _torch_family1 import check_losses, player_cases


@pytest.mark.parametrize("mode,player", player_cases(["vegan-mmd", "vegan-kl", "vegan-ikl", "vegan-jsd", "vae"]))
def test_losses_and_gradients_match_jax(mode, player):
    check_losses("cifar10", mode, player)
