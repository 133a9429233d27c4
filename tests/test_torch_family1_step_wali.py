"""The port's alternating step against the JAX ``make_train_step`` for
``wali`` on mnist: RMSProp 5e-5 and the weight clip of every D parameter
to ±0.01 after each D update (``tflib/objs/gan_inference.py:15-24``), 3
iterations at dim 8, B 4, k = 2, f32, from the same parameters, batches
and draws. Tolerances: costs to 1e-3 of max(1, |ref|); each parameter
within 2.6·lr per update of its player (the bound the Adam cases use; f32
sums in other orders move RMSProp's steps far less), the D parameters
inside the clip box; RMSProp's mean square within 1e-2 of its leaf's
largest element.
"""

import numpy as np

from _torch_family1 import run_steps


def test_three_iterations_match_jax_step_and_clip():
    js, ts, costs = run_steps("mnist", "wali", critic_iters=2)
    for row in costs:
        for want, got in row.values():
            assert abs(got - want) <= 1e-3 * max(1.0, abs(want))
    for name, want in js.params.items():
        got = ts.params[name].numpy()
        updates = 6 if name.startswith("Discriminator") else 2
        assert np.abs(got - np.asarray(want)).max() <= 2.6 * 5e-5 * updates
        if name.startswith("Discriminator"):
            assert np.abs(got).max() <= 0.01
    for name, want in js.disc_opt["ms"].items():
        d = np.abs(ts.disc_opt["ms"][name].numpy() - np.asarray(want)).max()
        assert d <= 1e-2 * np.abs(np.asarray(want)).max() + 1e-14, name
