"""Training pools of family 1: what ``run()`` trains on when the dataset
files are absent (as in ``graphical_gan_tpu/runs/gan_inference.py:
350-358``), numpy only.

Each pool is ``materialize_epoch`` of a loader's train factory: the
synthetic fallback's train split (or the structured family's), one epoch at
the config's batch size with the partial last batch dropped, its order
seeded with ``EPOCH_SEED`` (the JAX loaders leave it unseeded), so a run's
pool is the same from run to run. The rows come from the loaders alone;
this module only names the sizes, with the JAX loaders' as defaults (the
tests run them small):

- mnist ``images_unit(50000, 784, 0)`` (``data/mnist.py``: the train split
  of ``synthetic_sizes``), float32 in [0, 1];
- cifar10 ``images_int(50000, 3072, 0)`` (``data/cifar10.py``);
- svhn ``images_int(73257, 3072, 0)`` (``data/svhn.py``);
- celeba ``images_int(20000, 12288, 7)`` shuffled by ``RandomState(0)``,
  the first ``num_dev = 5000`` held out as dev, the other 15,000 trained on
  (``data/celeba.py``);
- ``structured``: the first 20,000 of the learnable family's 24,000-image
  draw (``structured_loaders``), through an epoch seeded 1.

The integer pixels come out as uint8, as the JAX run makes them resident.
"""

from __future__ import annotations

import numpy as np

from graphical_gan_tpu_torch.data import synthetic
from graphical_gan_tpu_torch.data.common import (
    generator_factory, materialize_epoch)


# The structured family's draw and its train epoch's seed.
STRUCTURED_SEED = 0
STRUCTURED_EPOCH_SEED = 1
# The port's seed of the epoch order, which the JAX loaders leave unseeded.
EPOCH_SEED = 0


def mnist(batch_size: int, n: int = 50_000) -> np.ndarray:
    from graphical_gan_tpu_torch.data import mnist as loader
    train, _, _ = loader.load(batch_size, batch_size,
                              synthetic_sizes=(n, 10_000, 10_000),
                              seed=EPOCH_SEED)
    return materialize_epoch(train)


def cifar10(batch_size: int, n: int = 50_000) -> np.ndarray:
    from graphical_gan_tpu_torch.data import cifar10 as loader
    train, _ = loader.load(batch_size, synthetic_sizes=(n, 10_000),
                           seed=EPOCH_SEED)
    return materialize_epoch(train, dtype=np.uint8)


def svhn(batch_size: int, n: int = 73_257) -> np.ndarray:
    from graphical_gan_tpu_torch.data import svhn as loader
    train, _ = loader.load(batch_size, synthetic_sizes=(n, 26_032),
                           seed=EPOCH_SEED)
    return materialize_epoch(train, dtype=np.uint8)


def celeba(batch_size: int, n: int = 20_000,
           num_dev: int = 5000) -> np.ndarray:
    from graphical_gan_tpu_torch.data import celeba as loader
    train, _ = loader.load(batch_size, num_dev=num_dev, synthetic_size=n,
                           seed=EPOCH_SEED)
    return materialize_epoch(train, dtype=np.uint8)


def structured_loaders(batch_size: int, image_hw, channels: int,
                       unit: bool, n_train: int = 20_000,
                       n_eval: int = 2000, n_classes: int = 10,
                       seed: int = STRUCTURED_SEED):
    """The learnable labeled family in the dataset's batch convention
    (``unit``: float [0, 1], else raw int pixels): ``(train, dev, raw)``,
    the train and dev factories (epochs seeded 1 and 2) and ``raw`` the
    ``(train_flat, train_y, eval_flat, eval_y)`` a quality classifier
    trains on (the draw's last ``n_eval`` rows held out of both)."""
    n = n_train + 2 * n_eval
    flat, y = synthetic.structured_images_labeled(
        n, tuple(image_hw), channels, n_classes, seed)
    feed = (flat / 255.0).astype(np.float32) if unit else flat
    sl = [slice(0, n_train), slice(n_train, n_train + n_eval),
          slice(n_train + n_eval, n)]
    tr, dv = (generator_factory(batch_size, feed[s], y[s],
                                seed=STRUCTURED_EPOCH_SEED + i)
              for i, s in enumerate(sl[:2]))
    return tr, dv, (flat[sl[0]], y[sl[0]], flat[sl[2]], y[sl[2]])


def structured(batch_size: int, image_hw, channels: int, unit: bool,
               n_train: int = 20_000, n_eval: int = 2000) -> np.ndarray:
    train, _, _ = structured_loaders(batch_size, image_hw, channels, unit,
                                     n_train, n_eval)
    return materialize_epoch(train, dtype=None if unit else np.uint8)


SYNTHETIC = {"mnist": mnist, "cifar10": cifar10, "svhn": svhn,
             "celeba": celeba}
