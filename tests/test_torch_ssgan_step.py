"""SSGAN training steps: the port's ``make_train_step`` against the JAX
package's over 2 iterations (iteration 0 skips the G update) from the same
parameters, raw batches and draws (``tests/_torch_ssgan.py: run_steps``),
held as the family-1 step tests hold theirs (``tests/_torch_family1.py:
check_states``: costs to 1e-3 of max(1, |ref|), each parameter within
2.6e-4 per update of its player, Adam's moments to 1e-2 of the leaf's
largest, rounding-noise leaves to the noise level). The batches are
moving-MNIST ``{'x', 'y'}`` dicts [1+k, B, ...], which the step's tree
helpers (``core/tree.py``) index, split and place; ``accum_steps=2``
splits each dict update into microbatches of their own draws. (Chairs'
plain video batches and the 3dcnn D with BN are held at the loss and
gradient level, ``test_torch_ssgan_losses_3dcnn.py``.)
"""

from _torch_family1 import check_states
from _torch_ssgan import run_steps


def test_local_ep_gsp_two_iterations_match_jax_step():
    js, ts, costs = run_steps("moving_mnist", "local_ep", pos_mode="gsp")
    check_states(js, ts, costs, 1, iters=2)


def test_accumulated_dict_batches_match_jax_step():
    """accum_steps=2 at B 4 (2 videos per microbatch), alice-z concat_z."""
    js, ts, costs = run_steps("moving_mnist", "alice-z", accum=2,
                              ali_mode="concat_z", pos_mode="inverse",
                              batch_size=4, seq_len=3)
    check_states(js, ts, costs, 1, iters=2)

