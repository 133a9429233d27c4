"""Training pools of family 1: what the JAX ``run()`` trains on when the
dataset files are absent (``graphical_gan_tpu/runs/gan_inference.py:
350-358``, ``materialize_epoch`` of the loader's train split), numpy only.

Each pool is the train split of the JAX loader's synthetic fallback, at the
same sizes and seeds, taken through one epoch of ``generator_factory``: one
permutation of the rows, and the partial last batch at the config's batch
size dropped. The JAX loaders draw that permutation unseeded; here it comes
from ``EPOCH_SEED``, so a run's pool is the same from run to run. The sizes
are parameters (the tests run them small), with the JAX loaders' as
defaults; the seeds are the constants below, named after the loaders':

- mnist ``images_unit(50000, 784, 0)`` (``data/mnist.py``: the train split
  of ``synthetic_sizes``, seed 0), float32 in [0, 1];
- cifar10 ``images_int(50000, 3072, 0)`` (``data/cifar10.py``);
- svhn ``images_int(73257, 3072, 0)`` (``data/svhn.py``);
- celeba ``images_int(20000, 12288, 7)`` shuffled by ``RandomState(0)``,
  the first ``num_dev = 5000`` held out as dev, the other 15,000 trained on
  (``data/celeba.py``);
- ``structured``: the first 20,000 of the learnable family's 24,000-image
  draw, through an epoch seeded 1 (``runs/gan_inference.py:
  _structured_pool``).

The integer pixels come out as uint8, as the JAX run makes them resident.
"""

from __future__ import annotations

import numpy as np

from graphical_gan_tpu_torch.data import synthetic


# The JAX loaders' seeds: the synthetic draw of each train split, celeba's
# dev/train shuffle, and the structured family's draw and epoch.
MNIST_SEED = 0
CIFAR10_SEED = 0
SVHN_SEED = 0
CELEBA_SEED = 7
CELEBA_SHUFFLE_SEED = 0
STRUCTURED_SEED = 0
STRUCTURED_EPOCH_SEED = 1
# The port's seed of the epoch order, which the JAX loaders leave unseeded.
EPOCH_SEED = 0


def epoch(x: np.ndarray, batch_size: int, seed: int = EPOCH_SEED
          ) -> np.ndarray:
    """The rows of one epoch of ``generator_factory(batch_size, x,
    seed=seed)``, in its order: the partial last batch dropped."""
    n = len(x)
    perm = np.random.RandomState(seed).permutation(n)
    return x[perm[:n // batch_size * batch_size]]


def mnist(batch_size: int, n: int = 50_000) -> np.ndarray:
    return epoch(synthetic.images_unit(n, 784, MNIST_SEED), batch_size)


def cifar10(batch_size: int, n: int = 50_000) -> np.ndarray:
    flat = synthetic.images_int(n, 3072, CIFAR10_SEED).astype(np.uint8)
    return epoch(flat, batch_size)


def svhn(batch_size: int, n: int = 73_257) -> np.ndarray:
    flat = synthetic.images_int(n, 3072, SVHN_SEED).astype(np.uint8)
    return epoch(flat, batch_size)


def celeba(batch_size: int, n: int = 20_000,
           num_dev: int = 5000) -> np.ndarray:
    flat = synthetic.images_int(n, 64 * 64 * 3, CELEBA_SEED).astype(np.uint8)
    np.random.RandomState(CELEBA_SHUFFLE_SEED).shuffle(flat)
    return epoch(flat[num_dev:], batch_size)


def structured(batch_size: int, image_hw, channels: int, unit: bool,
               n_train: int = 20_000, n_eval: int = 2000) -> np.ndarray:
    flat, _ = synthetic.structured_images_labeled(
        n_train + 2 * n_eval, tuple(image_hw), channels, 10, STRUCTURED_SEED)
    flat = flat[:n_train]
    feed = (flat / 255.0).astype(np.float32) if unit else flat.astype(
        np.uint8)
    return epoch(feed, batch_size, STRUCTURED_EPOCH_SEED)


SYNTHETIC = {"mnist": mnist, "cifar10": cifar10, "svhn": svhn,
             "celeba": celeba}
