"""On-device resident datasets (``graphical_gan_tpu/data/ondevice.py``).

A cifar10-sized training set fits on the card many times over (50,000 x
3,072 bytes as uint8), so it is uploaded once and each iteration's
(1+k) batches are gathered there by indices drawn on the card: no host
copy in the training loop. A dataset may be a dict of aligned arrays
(SSGAN's ``{'x', 'y'}``): each leaf is uploaded, and one index draw is
shared by every leaf, so the pairs stay paired.
"""

from __future__ import annotations

import numpy as np
import torch

from graphical_gan_tpu_torch.core import tree


def to_device(array, device):
    """Upload a host array (or each array of a dict) once, in its own dtype
    (integer pixels stay uint8, as ``runs/gan_inference.py:353-358`` keeps
    them)."""
    return tree.tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), array)


def sample_batches(data, n_batches: int, batch_size: int,
                   generator: torch.Generator):
    """[n_batches, batch_size, ...] drawn uniformly with replacement (an
    epochless stream, as the JAX ``sample_batches`` and
    ``sample_batches_tree``); the indices come from ``generator``, which
    lives on the data's device, one draw for every leaf of a dict."""
    first = tree.first_leaf(data)
    idx = torch.randint(0, first.shape[0], (n_batches * batch_size,),
                        generator=generator, device=first.device)
    return tree.tree_map(
        lambda x: x.index_select(0, idx).reshape(
            (n_batches, batch_size) + tuple(x.shape[1:])), data)


def epoch_batches_ondevice(data, batch_size: int,
                           generator: torch.Generator):
    """One shuffled epoch as [n_batches, batch_size, ...]: a permutation
    without replacement drawn on the data's device from ``generator`` (the
    reference's epoch semantics, ``tflib/cifar10.py:32-39``), the remainder
    dropped; one permutation for every leaf of a dict."""
    first = tree.first_leaf(data)
    n = first.shape[0]
    n_batches = n // batch_size
    perm = torch.randperm(n, generator=generator,
                          device=first.device)[:n_batches * batch_size]
    return tree.tree_map(
        lambda x: x.index_select(0, perm).reshape(
            (n_batches, batch_size) + tuple(x.shape[1:])), data)
