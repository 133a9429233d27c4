"""The complete Inception-v3 (2015 ``classify_image``) architecture through
the port's interpreter and the JAX package's, on the CPU, at 299x299 with
batch 1: pool_3 within 1e-4 relative L2 (about 100 chained f32 conv + BN
layers, each summed in another order), the probabilities of the bias-free
head within 1e-6.

The graph is chip_smoke.py's (the op sequence and channel plan of
tests/test_inception_full_graph.py: _V3Builder, its random weights from
seed 0; tests/test_torch_graphdef.py holds the two graphs equal), so no
TensorFlow is needed.
"""

import os
import sys

import numpy as np
import torch

from graphical_gan_tpu.metrics import graphdef as jax_graphdef
from graphical_gan_tpu.metrics import inception_frozen as jax_frozen
from graphical_gan_tpu_torch.metrics import graphdef
from graphical_gan_tpu_torch.metrics import inception_frozen as frozen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

POOL_REL_L2 = 1e-4
PROB_ATOL = 1e-6


def test_full_inception_v3_pool3_and_head_match_jax():
    data = chip_smoke.inception_v3_2015_graphdef(seed=0)
    x = np.random.RandomState(1).rand(1, 299, 299, 3).astype(np.float32) \
        * 255.0
    jint = jax_frozen.GraphInterpreter(jax_graphdef.parse_graphdef(data))
    want_pool, w = jint.make_fn("ExpandDims", ["pool_3", "softmax/w"])(
        jint.consts, x)
    want_pool = np.asarray(want_pool)
    logits = want_pool.reshape(1, -1) @ np.asarray(w)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    want_probs = e / e.sum(axis=1, keepdims=True)

    clf = frozen.FrozenInceptionClassifier(graphdef.parse_graphdef(data),
                                           device="cpu")
    pool, probs = clf.pool3_and_probs(torch.from_numpy(x))
    pool, probs = pool.numpy(), probs.numpy()
    assert pool.shape == want_pool.shape == (1, 1, 1, 2048)
    rel = np.linalg.norm(pool - want_pool) / np.linalg.norm(want_pool)
    assert rel < POOL_REL_L2, rel
    assert probs.shape == (1, 1008)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROB_ATOL)
    # the head spreads the probabilities even with small random weights
    assert probs.max() > 1.5 / 1008
