"""The port's training pools (graphical_gan_tpu_torch/data/pools.py) against
what the JAX ``run()`` trains on: ``materialize_epoch`` of the JAX loader's
train split, here its synthetic fallback (``maybe_download`` patched to
fail, so nothing leaves the machine), at the config's batch size and at
small pool sizes passed to both sides. The JAX loaders draw their epoch
order unseeded: with that order, the pools agree as sets of rows; with the
JAX epoch seeded as the port seeds its own, they agree row for row. The
defaults (sizes, ``num_dev``) are read from the JAX loaders' signatures.
And the CLI with no flags trains mnist ``ali``, as the JAX entry does.
"""

import functools
import inspect
import os

import numpy as np
import pytest

from graphical_gan_tpu.data import celeba as jax_celeba
from graphical_gan_tpu.data import cifar10 as jax_cifar10
from graphical_gan_tpu.data import common as jax_common
from graphical_gan_tpu.data import mnist as jax_mnist
from graphical_gan_tpu.data import svhn as jax_svhn
from graphical_gan_tpu.runs import gan_inference as jax_run
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.data import pools
from graphical_gan_tpu_torch.runs.gan_inference import main, resident_data

DATASETS = ["mnist", "cifar10", "svhn", "celeba"]
LOADERS = {"mnist": jax_mnist, "cifar10": jax_cifar10, "svhn": jax_svhn,
           "celeba": jax_celeba}


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No download, and the numpy gather (no native build) in the JAX
    loaders' epochs."""
    for mod in (jax_mnist, jax_svhn):
        monkeypatch.setattr(mod, "maybe_download", lambda *a, **k: False)
    monkeypatch.setenv("GGAN_BATCHER_THREADS", "1")


def _jax_pool(dataset, batch_size, n, tmp_path, num_dev=None):
    """The JAX run's resident array for ``dataset`` at pool size ``n``."""
    if dataset == "mnist":
        train, _, _ = jax_mnist.load(
            batch_size, batch_size, path=str(tmp_path / "mnist.pkl.gz"),
            synthetic_sizes=(n, 10, 10))
        return jax_common.materialize_epoch(train)
    if dataset == "cifar10":
        train, _ = jax_cifar10.load(batch_size, None, synthetic_sizes=(n, 10))
    elif dataset == "svhn":
        train, _ = jax_svhn.load(batch_size, str(tmp_path / "svhn"),
                                 synthetic_sizes=(n, 10))
    else:
        train, _ = jax_celeba.load(batch_size, None, num_dev=num_dev,
                                   synthetic_size=n)
    return jax_common.materialize_epoch(train, dtype=np.uint8)


def _port_pool(dataset, batch_size, n, num_dev=None):
    extra = {"num_dev": num_dev} if dataset == "celeba" else {}
    return pools.SYNTHETIC[dataset](batch_size, n=n, **extra)


def _rows(a):
    """The rows of ``a`` as a sorted list of bytes (a multiset of rows)."""
    return sorted(bytes(r) for r in np.ascontiguousarray(a))


def _batch(dataset):
    return gan_inference_defaults(dataset, "ali").batch_size


@pytest.mark.parametrize("dataset", DATASETS)
def test_pool_is_the_jax_epoch_as_a_set_of_rows(dataset, tmp_path):
    """Pool sizes that are whole batches: the unseeded JAX epoch holds
    every row of the split, and so does the port's."""
    b = _batch(dataset)
    n, num_dev = (3 * b + 5, 5) if dataset == "celeba" else (3 * b, None)
    want = _jax_pool(dataset, b, n, tmp_path, num_dev)
    got = _port_pool(dataset, b, n, num_dev)
    assert got.dtype == want.dtype and got.shape == want.shape == (
        3 * b, want.shape[1])
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("dataset", DATASETS)
def test_pool_is_the_seeded_jax_epoch_row_for_row(dataset, tmp_path,
                                                  monkeypatch):
    """A pool with a partial last batch: seeded as the port seeds its
    epoch, the JAX loader drops the same rows and keeps the same order."""
    b = _batch(dataset)
    n, num_dev = (2 * b + 17, 9) if dataset == "celeba" else (2 * b + 7,
                                                              None)
    monkeypatch.setattr(LOADERS[dataset], "generator_factory",
                        functools.partial(jax_common.generator_factory,
                                          seed=0))
    want = _jax_pool(dataset, b, n, tmp_path, num_dev)
    got = _port_pool(dataset, b, n, num_dev)
    assert got.shape[0] == 2 * b
    np.testing.assert_array_equal(got, want)


def test_pool_defaults_are_the_jax_loaders():
    """Sizes and ``num_dev`` from the JAX loaders' signatures; the seed
    constants (mnist's train split 0, cifar10 and svhn 0, celeba 7,
    celeba's split shuffle 0) are held by the two tests above, which build
    the pools from them, and the structured family's by the test below."""
    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    assert default(pools.mnist, "n") == default(jax_mnist.load,
                                                "synthetic_sizes")[0]
    assert default(pools.cifar10, "n") == default(jax_cifar10.load,
                                                  "synthetic_sizes")[0]
    assert default(pools.svhn, "n") == default(jax_svhn.load,
                                               "synthetic_sizes")[0] == 73257
    # celeba's fallback draws min(synthetic_size, 20000) images
    assert default(pools.celeba, "n") == min(
        default(jax_celeba.load, "synthetic_size"), 20000)
    assert default(pools.celeba, "num_dev") == default(jax_celeba.load,
                                                       "num_dev") == 5000
    sig = inspect.signature(jax_run._structured_pool).parameters
    assert default(pools.structured, "n_train") == sig["n_train"].default
    assert default(pools.structured, "n_eval") == sig["n_eval"].default


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_structured_pool_is_the_jax_epoch(dataset):
    cfg = gan_inference_defaults(dataset, "ali", batch_size=8)
    train, _, _ = jax_run._structured_pool(cfg, n_train=37, n_eval=3)
    unit = cfg.data.normalization == "unit"
    want = jax_common.materialize_epoch(
        train, dtype=None if unit else np.uint8)
    got = pools.structured(8, cfg.data.image_hw, cfg.data.channels, unit,
                           n_train=37, n_eval=3)
    assert got.shape == (32, cfg.data.output_dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset", DATASETS)
def test_resident_data_builds_the_pool_at_the_config_batch(dataset,
                                                          monkeypatch):
    calls = []
    monkeypatch.setitem(pools.SYNTHETIC, dataset,
                        lambda b: calls.append(b) or np.zeros((b, 1)))
    cfg = gan_inference_defaults(dataset, "ali")
    assert resident_data(cfg, None).shape == (cfg.batch_size, 1)
    assert calls == [cfg.batch_size]


def test_cli_without_flags_trains_mnist_ali(tmp_path):
    main(["--dim", "8", "--batch-size", "4", "--iters", "1",
          "--device", "cpu", "--outdir", str(tmp_path)])
    (d,) = os.listdir(tmp_path)
    assert d.startswith("gan_inference_mnist.MODE-ali.")
    with open(os.path.join(tmp_path, d, "logfile.txt")) as f:
        log = f.read()
    assert "\tDATASET: mnist\n" in log and "\tMODE: ali\n" in log
    assert [ln.split("\t")[0] for ln in log.splitlines()
            if ln.startswith("iter ")] == ["iter 0"]
