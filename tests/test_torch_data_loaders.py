"""The port's dataset loaders (graphical_gan_tpu_torch/data/{common,mnist,
cifar10,svhn,celeba}.py) against the JAX package's, on small files each
test writes in the dataset's own format: mnist's gzip pickle and its four
idx files, the CIFAR-10 pickle batches, an SVHN ``.mat`` written by
``scipy.io.savemat`` and ``celebA_64x64.npy``. With the JAX epochs seeded
as the port's (``generator_factory`` patched to seed 0) every split's
first two epochs agree batch for batch. The JAX loaders' ``maybe_download``
is patched to fail, so nothing leaves the machine, and the JAX gather is
numpy's (``GGAN_BATCHER_THREADS=1``). Also: the synthetic fallbacks,
``get_reconstruction_data`` with and without the files, the ``n_labelled``
mask, ``materialize_epoch``'s dtype cast, the resident pool of a data
directory, and the CLI training from one.
"""

import functools
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import scipy.io

from graphical_gan_tpu.data import celeba as jax_celeba
from graphical_gan_tpu.data import cifar10 as jax_cifar10
from graphical_gan_tpu.data import common as jax_common
from graphical_gan_tpu.data import mnist as jax_mnist
from graphical_gan_tpu.data import svhn as jax_svhn
from graphical_gan_tpu_torch.core.config import gan_inference_defaults
from graphical_gan_tpu_torch.data import celeba, cifar10, common, mnist, svhn
from graphical_gan_tpu_torch.runs.gan_inference import (
    _loaders, main, resident_data)

JAX_LOADERS = (jax_mnist, jax_cifar10, jax_svhn, jax_celeba)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No download; numpy's gather in the JAX epochs; the JAX epochs seeded
    as the port's (seed 0)."""
    for mod in (jax_common, jax_mnist, jax_svhn):
        if hasattr(mod, "maybe_download"):
            monkeypatch.setattr(mod, "maybe_download",
                                lambda *a, **k: False)
    monkeypatch.setenv("GGAN_BATCHER_THREADS", "1")
    for mod in JAX_LOADERS:
        monkeypatch.setattr(mod, "generator_factory", functools.partial(
            jax_common.generator_factory, seed=0))


def assert_epochs_equal(jax_factory, port_factory, epochs=2):
    """The first ``epochs`` epochs batch for batch (tuples element-wise)."""
    for _ in range(epochs):
        want, got = list(jax_factory()), list(port_factory())
        assert len(got) == len(want)
        for w, g in zip(want, got):
            w = w if isinstance(w, tuple) else (w,)
            g = g if isinstance(g, tuple) else (g,)
            assert len(g) == len(w)
            for a, b in zip(w, g):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(b, a)


# -- common ----------------------------------------------------------------------

@pytest.mark.parametrize("drop", [True, False])
def test_epoch_batches_is_the_jax_epoch(drop):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (23, 7)).astype(np.int32)
    y = rng.integers(0, 10, 23)
    want = list(jax_common.epoch_batches(
        5, x, y, rng=np.random.RandomState(4), drop_remainder=drop))
    got = list(common.epoch_batches(
        5, x, y, rng=np.random.RandomState(4), drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for (wx, wy), (gx, gy) in zip(want, got):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_paired_shuffle_is_the_jax_shuffle():
    a = np.arange(30).reshape(15, 2)
    b = np.arange(15)
    ja, jb, pa, pb = a.copy(), b.copy(), a.copy(), b.copy()
    jax_common.paired_shuffle(np.random.RandomState(3), ja, jb)
    common.paired_shuffle(np.random.RandomState(3), pa, pb)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pa[:, 0] // 2, pb)  # one permutation


@pytest.mark.parametrize("dtype", [None, np.uint8])
def test_materialize_epoch_casts_as_jax(dtype):
    x = np.random.default_rng(1).integers(0, 256, (20, 6)).astype(np.int32)
    y = np.arange(20)
    want = jax_common.materialize_epoch(
        jax_common.generator_factory(3, x, y, seed=5), dtype=dtype)
    got = common.materialize_epoch(
        common.generator_factory(3, x, y, seed=5), dtype=dtype)
    assert got.dtype == want.dtype == (dtype or np.int32)
    assert got.shape == (18, 6)
    np.testing.assert_array_equal(got, want)


def test_materialize_epoch_concatenates_dict_batches():
    def factory():
        for i in range(3):
            yield {"x": np.full((2, 3), i, np.int32), "y": np.arange(2) + i}
    want = jax_common.materialize_epoch(factory, dtype=np.int64)
    got = common.materialize_epoch(factory, dtype=np.int64)
    assert set(got) == {"x", "y"}
    for k in got:
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k])


# -- mnist -------------------------------------------------------------------------

def _mnist_splits(rng, sizes=(40, 12, 12)):
    return tuple((rng.random((n, 784), dtype=np.float32),
                  rng.integers(0, 10, n).astype(np.int64)) for n in sizes)


def _write_idx(path, arr):
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("n_labelled", [None, 5])
def test_mnist_pickle_is_the_jax_split(tmp_path, n_labelled):
    path = str(tmp_path / "mnist.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump(_mnist_splits(np.random.default_rng(2)), f, protocol=2)
    want = jax_mnist.load(8, 4, n_labelled=n_labelled, path=path)
    got = mnist.load(8, 4, n_labelled=n_labelled, path=path, seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


def test_mnist_labelled_mask_is_the_batch_slice(tmp_path):
    """The mask travels with its rows: n_labelled rows flagged per epoch,
    one flag per image of the batch (the JAX divergence from the
    reference's whole-vector mask)."""
    path = str(tmp_path / "mnist.pkl.gz")
    splits = _mnist_splits(np.random.default_rng(3))
    with gzip.open(path, "wb") as f:
        pickle.dump(splits, f, protocol=2)
    train, _, _ = mnist.load(8, 4, n_labelled=5, path=path, seed=0)
    flagged = []
    for x, y, mask in train():
        assert mask.shape == (8,) and mask.dtype == np.int32
        flagged += [bytes(r) for r in x[mask == 1]]
    labelled = {bytes(r) for r in splits[0][0][:5]}
    assert set(flagged) <= labelled and len(flagged) <= 5


def test_mnist_idx_files_are_the_jax_splits(tmp_path):
    rng = np.random.default_rng(4)
    files = {"train_x": rng.integers(0, 256, (24, 28, 28)),
             "train_y": rng.integers(0, 10, 24),
             "test_x": rng.integers(0, 256, (10, 28, 28)),
             "test_y": rng.integers(0, 10, 10)}
    for key, arr in files.items():
        _write_idx(tmp_path / mnist.IDX_FILES[key], arr)
    path = str(tmp_path / "mnist.pkl.gz")  # absent: the idx files are read
    want = jax_mnist.load(4, 4, path=path)
    got = mnist.load(4, 4, path=path, seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)
    x0 = next(iter(got[0]()))[0]
    assert x0.dtype == np.float32 and float(x0.max()) <= 1.0


def test_mnist_synthetic_fallback_is_the_jax_fallback(tmp_path):
    sizes = (30, 9, 9)
    want = jax_mnist.load(4, 4, path=str(tmp_path / "none.pkl.gz"),
                          synthetic_sizes=sizes)
    got = mnist.load(4, 4, path=None, synthetic_sizes=sizes, seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


# -- cifar10 -----------------------------------------------------------------------

def _write_cifar(dirpath, rng, rows=10):
    data = {}
    for name in cifar10.TRAIN_FILES + cifar10.TEST_FILES:
        x = rng.integers(0, 256, (rows, 3072)).astype(np.uint8)
        y = rng.integers(0, 10, rows).tolist()
        with open(os.path.join(dirpath, name), "wb") as f:
            pickle.dump({"data": x, "labels": y}, f, protocol=2)
        data[name] = x
    return data


def test_cifar10_batches_are_the_jax_splits(tmp_path):
    _write_cifar(tmp_path, np.random.default_rng(5))
    want = jax_cifar10.load(8, str(tmp_path))
    got = cifar10.load(8, str(tmp_path), seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)
    assert next(iter(got[0]()))[0].dtype == np.int32


def test_cifar10_synthetic_fallback_is_the_jax_fallback(tmp_path):
    want = jax_cifar10.load(8, str(tmp_path), synthetic_sizes=(40, 16))
    got = cifar10.load(8, str(tmp_path), synthetic_sizes=(40, 16), seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


@pytest.mark.parametrize("with_files", [True, False])
def test_cifar10_reconstruction_batch_is_the_jax_batch(tmp_path, with_files):
    if with_files:
        data = _write_cifar(tmp_path, np.random.default_rng(6), rows=50)
    want = jax_cifar10.get_reconstruction_data(16, str(tmp_path))
    got = cifar10.get_reconstruction_data(16, str(tmp_path))
    assert got.shape == (16, 3072)
    np.testing.assert_array_equal(got, want)
    if with_files:  # a fixed-seed subset of the test batch
        assert {bytes(r) for r in got} <= {bytes(r)
                                           for r in data["test_batch"]}


# -- svhn ----------------------------------------------------------------------------

def _write_svhn(dirpath, rng):
    for name, n in ((svhn.TRAIN_FILE, 20), (svhn.TEST_FILE, 9)):
        x = rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8)  # HWCN
        y = rng.integers(1, 11, (n, 1)).astype(np.uint8)  # 10 is a zero
        scipy.io.savemat(os.path.join(dirpath, name), {"X": x, "y": y})


def test_svhn_mat_files_are_the_jax_splits(tmp_path):
    _write_svhn(tmp_path, np.random.default_rng(7))
    want = jax_svhn.load(4, str(tmp_path))
    got = svhn.load(4, str(tmp_path), seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)
    x, y = next(iter(got[0]()))
    assert x.shape == (4, 3072) and x.dtype == np.int32
    assert y.max() <= 9


def test_svhn_synthetic_fallback_is_the_jax_fallback(tmp_path):
    want = jax_svhn.load(4, str(tmp_path), synthetic_sizes=(20, 8))
    got = svhn.load(4, str(tmp_path), synthetic_sizes=(20, 8), seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


# -- celeba --------------------------------------------------------------------------

@pytest.mark.parametrize("num_dev", [6, 0])
def test_celeba_npy_is_the_jax_split(tmp_path, num_dev):
    arr = np.random.default_rng(8).integers(0, 256, (30, 3, 64, 64)).astype(
        np.uint8)
    np.save(tmp_path / celeba.FILENAME, arr)
    want = jax_celeba.load(4, str(tmp_path), num_dev=num_dev)
    got = celeba.load(4, str(tmp_path), num_dev=num_dev, seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


def test_celeba_synthetic_fallback_is_the_jax_fallback(tmp_path):
    want = jax_celeba.load(4, str(tmp_path), num_dev=5, synthetic_size=25)
    got = celeba.load(4, str(tmp_path), num_dev=5, synthetic_size=25, seed=0)
    for w, g in zip(want, got):
        assert_epochs_equal(w, g)


def test_celeba_center_crop_is_the_jax_crop():
    x = np.random.default_rng(9).integers(0, 256, (90, 70, 3)).astype(
        np.float64)
    np.testing.assert_array_equal(celeba.center_crop(x),
                                  jax_celeba.center_crop(x))


# -- the run's resident pool and the CLI ------------------------------------------------

@pytest.mark.parametrize("dataset", ["cifar10", "svhn", "celeba", "mnist"])
def test_resident_pool_of_a_data_dir_is_the_jax_run_pool(tmp_path, dataset):
    """``resident_data(cfg, DIR)``: ``materialize_epoch`` of the JAX
    loader's train split on the same files (uint8 for integer pixels)."""
    rng = np.random.default_rng(10)
    cfg = gan_inference_defaults(dataset, "ali", batch_size=4)
    if dataset == "cifar10":
        _write_cifar(tmp_path, rng)
        train, _ = jax_cifar10.load(4, str(tmp_path))
    elif dataset == "svhn":
        _write_svhn(tmp_path, rng)
        train, _ = jax_svhn.load(4, str(tmp_path))
    elif dataset == "celeba":
        # the run's split holds out num_dev = 5000 rows as its dev set
        np.save(tmp_path / celeba.FILENAME,
                rng.integers(0, 256, (5009, 3, 64, 64), dtype=np.uint8))
        train, _ = jax_celeba.load(4, str(tmp_path), num_dev=5000)
    else:
        with gzip.open(tmp_path / "mnist.pkl.gz", "wb") as f:
            pickle.dump(_mnist_splits(rng), f, protocol=2)
        train, _, _ = jax_mnist.load(4, 4, path=str(tmp_path / "mnist.pkl.gz"))
    unit = dataset == "mnist"
    want = jax_common.materialize_epoch(train,
                                        dtype=None if unit else np.uint8)
    got = resident_data(cfg, str(tmp_path))
    assert got.dtype == (np.float32 if unit else np.uint8)
    np.testing.assert_array_equal(got, want)


def test_run_loaders_of_no_dir_give_the_synthetic_pool():
    """run() materializes its loader's first epoch, seeded as the pools:
    without a data directory that is ``data/pools.py``'s pool."""
    cfg = gan_inference_defaults("mnist", "ali")
    train, _, structured = _loaders(cfg, None)
    assert structured is None
    np.testing.assert_array_equal(resident_data(cfg, None, train),
                                  resident_data(cfg, None))


def test_cli_trains_from_a_cifar10_data_dir(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_cifar(data, np.random.default_rng(11))
    out = tmp_path / "out"
    main(["--dataset", "cifar10", "--mode", "wali-gp", "--dim", "8",
          "--batch-size", "4", "--iters", "2", "--device", "cpu",
          "--data-dir", str(data), "--outdir", str(out)])
    (d,) = os.listdir(out)
    with open(out / d / "logfile.txt") as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("iter ")]
    assert [ln.split("\t")[0] for ln in lines] == ["iter 0", "iter 1"]
    costs = [float(ln.split("train disc cost\t")[1].split("\t")[0])
             for ln in lines]
    assert np.isfinite(costs).all()
