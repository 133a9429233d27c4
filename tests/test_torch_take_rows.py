"""The row gather of the loaders (``graphical_gan_tpu_torch/data/
common.py: take_rows``, ``gather_rows_threaded``) against numpy's
``a[idx]`` and the JAX package's threaded C++ gather
(``graphical_gan_tpu/native/batcher.cc`` through ``batcher_ext.
gather_rows_native``, built here into the test's directory with the JAX
build's flags): every dtype (the rows move as bytes), 1-d to 4-d arrays,
empty index lists and zero-width rows, in-range negative indices (they
wrap), out-of-range ones (IndexError), 1 to 8 threads, and
``epoch_batches`` gathering through it above the threshold.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from graphical_gan_tpu.native import batcher_ext
from graphical_gan_tpu_torch.data import common

DTYPES = [np.float32, np.float64, np.float16, np.uint8, np.int8, np.int16,
          np.int32, np.int64, np.uint16, np.uint32, np.uint64, np.bool_,
          np.complex64, np.complex128,
          np.dtype([("x", "<i4"), ("y", "<f8")])]
SHAPES = [(37,), (37, 5), (37, 3, 4), (37, 2, 3, 2), (37, 0)]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's C++ gather built into this test's directory (g++, the JAX
    build's flags) and set as its binding's function."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the JAX package's native gather")
    src = os.path.join(os.path.dirname(batcher_ext.__file__), "batcher.cc")
    so = str(tmp_path_factory.mktemp("native") / "libbatcher.so")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", "-pthread", src, "-o", so], check=True)
    f = ctypes.CDLL(so).gather_rows
    f.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                  ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int32]
    f.restype = None
    saved = batcher_ext._FN
    batcher_ext._FN = f
    yield f
    batcher_ext._FN = saved


def _array(dtype, shape, rng):
    dtype = np.dtype(dtype)
    raw = rng.integers(0, 256, (int(np.prod(shape)) * dtype.itemsize,),
                       dtype=np.uint8)
    a = raw.view(dtype).reshape(shape) if raw.size else np.zeros(shape,
                                                                  dtype)
    if dtype == np.bool_:
        a = a.view(np.uint8) % 2 == 1
    return np.ascontiguousarray(a)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name
                         or str(d))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gather_equals_numpy_and_jax_native(jax_native, dtype, shape):
    rng = np.random.default_rng(0)
    a = _array(dtype, shape, rng)
    for idx in (rng.integers(-37, 37, 64), np.arange(37)[::-1],
                np.zeros(0, np.int64), np.array([-37, 36, 0, -1])):
        want = a[idx]
        for k in (1, 3, 8):
            _equal(common.gather_rows_threaded(a, idx, n_threads=k), want)
        _equal(batcher_ext.gather_rows_native(a, idx), want)
        _equal(common.take_rows(a, idx), want)


@pytest.mark.parametrize("idx", [[37], [-38], [0, 100], [-1000]])
def test_out_of_range_raises_like_numpy_and_jax(jax_native, idx):
    a = np.arange(37 * 3, dtype=np.float32).reshape(37, 3)
    with pytest.raises(IndexError):
        a[np.asarray(idx)]
    with pytest.raises(IndexError):
        batcher_ext.gather_rows_native(a, np.asarray(idx))
    with pytest.raises(IndexError):
        common.gather_rows_threaded(a, np.asarray(idx), n_threads=2)


def test_unsuitable_inputs_fall_back_to_numpy():
    a = np.arange(40, dtype=np.float32).reshape(10, 4)
    assert common.gather_rows_threaded(a[:, ::2], [1, 2]) is None
    assert common.gather_rows_threaded(a, np.zeros((2, 2), int)) is None
    assert common.gather_rows_threaded(np.array([{}, {}]), [0]) is None
    _equal(common.take_rows(a[:, ::2], [1, 2]), a[:, ::2][[1, 2]])
    _equal(common.gather_rows_threaded(a, [3, 1]), a[[3, 1]])


def test_large_gathers_go_threaded_and_epoch_batches_use_it(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.random((256, 2048), dtype=np.float32)   # 8 KiB rows
    y = rng.integers(0, 10, 256)
    monkeypatch.setenv("GGAN_BATCHER_THREADS", "4")
    calls = []
    real = common.gather_rows_threaded

    def spy(a, idx, *args, **kw):
        calls.append(len(idx))
        return real(a, idx, *args, **kw)

    monkeypatch.setattr(common, "gather_rows_threaded", spy)
    got = list(common.epoch_batches(128, x, y,
                                    rng=np.random.RandomState(0)))
    perm = np.random.RandomState(0).permutation(256)
    for i, (bx, by) in enumerate(got):
        _equal(bx, x[perm[i * 128:(i + 1) * 128]])
        _equal(by, y[perm[i * 128:(i + 1) * 128]])
    assert calls == [128, 128]  # the 1 MiB image batches, not the labels
    monkeypatch.setenv("GGAN_BATCHER_THREADS", "1")
    calls.clear()
    list(common.epoch_batches(128, x, rng=np.random.RandomState(0)))
    assert calls == []  # one thread: numpy's gather
