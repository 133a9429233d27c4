"""On-device resident datasets (``graphical_gan_tpu/data/ondevice.py``).

A cifar10-sized training set fits on the card many times over (50,000 x
3,072 bytes as uint8), so it is uploaded once and each iteration's
(1+k) batches are gathered there by indices drawn on the card: no host
copy in the training loop.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """Upload a host array once, in its own dtype (integer pixels stay
    uint8, as ``runs/gan_inference.py:353-358`` keeps them)."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def sample_batches(data: torch.Tensor, n_batches: int, batch_size: int,
                   generator: torch.Generator) -> torch.Tensor:
    """[n_batches, batch_size, ...] drawn uniformly with replacement (an
    epochless stream, as the JAX ``sample_batches``); the indices come from
    ``generator``, which lives on the data's device."""
    n = data.shape[0]
    idx = torch.randint(0, n, (n_batches * batch_size,), generator=generator,
                        device=data.device)
    batch = data.index_select(0, idx)
    return batch.reshape((n_batches, batch_size) + tuple(data.shape[1:]))
