"""SSGAN's data paths against the JAX package's, and the trainer's dict
batches.

- moving-MNIST, host side (``data/moving_mnist.py``): the port's "native"
  stream against JAX's ``_video_generator`` running its C++ synthesizer
  (``graphical_gan_tpu/native/moving_mnist.cc``, compiled here into the
  test's own directory and handed to JAX's binding, so the shared build
  directory is not touched), and the "numpy" stream against JAX's
  ``use_native=False``; ``load_video`` and ``load_image`` from the same
  digit pools: equal arrays.
- moving-MNIST on the device (``data/ondevice_moving_mnist.py``): videos and
  the sampler's batches from JAX's own draws, equal arrays.
- chairs (``data/chairs.py``): every clip mode's epochs, from the synthetic
  fallback and from a ``chairs_8.npy``: equal arrays.
- the trainer: resident dict data sampled with one index draw for every
  leaf, a ``batch_sampler``, host-fed dict batches stacked per leaf, and
  the dev sweep over dict batches under its resident cap.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graphical_gan_tpu.data import chairs as jax_chairs
from graphical_gan_tpu.data import moving_mnist as jax_mm
from graphical_gan_tpu.data import ondevice_moving_mnist as jax_dev
from graphical_gan_tpu.native import moving_mnist_ext
from graphical_gan_tpu_torch.data import chairs, moving_mnist
from graphical_gan_tpu_torch.data import ondevice_moving_mnist as dev_mm
from graphical_gan_tpu_torch.train import trainer as trainer_mod

from _torch_ssgan import models, raw_batch


def _epochs(factory, n_epochs=2, n_batches=3):
    out = []
    for _ in range(n_epochs):
        for i, batch in enumerate(factory()):
            if i == n_batches:
                break
            out.append(batch)
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's C++ synthesizer built into this test's directory (g++, the
    JAX build's flags) and set as its binding's function."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the JAX package's native synthesizer")
    src = os.path.join(os.path.dirname(moving_mnist_ext.__file__),
                       "moving_mnist.cc")
    so = str(tmp_path_factory.mktemp("native") / "libmoving_mnist.so")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", "-pthread", src, "-o", so], check=True)
    f = ctypes.CDLL(so).synthesize_moving_mnist
    f.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                  ctypes.c_int, ctypes.c_uint64,
                  ctypes.POINTER(ctypes.c_float)]
    f.restype = None
    saved = moving_mnist_ext._FN
    moving_mnist_ext._FN = f
    yield f
    moving_mnist_ext._FN = saved


def _pool(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 28, 28).astype(np.float32), rng.randint(0, 10, n)


@pytest.mark.parametrize("seq_len,batch", [(16, 8), (31, 5), (3, 7)])
def test_native_stream_matches_jax_native_synthesizer(jax_native, seq_len,
                                                       batch):
    x, y = _pool()
    want = _epochs(jax_mm._video_generator(x, y, seq_len, batch, 4,
                                           use_native=True))
    got = _epochs(moving_mnist._video_generator(x, y, seq_len, batch, 4))
    _assert_same(got, want)


@pytest.mark.parametrize("seq_len,batch", [(16, 8), (4, 3)])
def test_numpy_stream_matches_jax_without_native(seq_len, batch):
    x, y = _pool(seed=1)
    want = _epochs(jax_mm._video_generator(x, y, seq_len, batch, 2,
                                           use_native=False))
    got = _epochs(moving_mnist._video_generator(x, y, seq_len, batch, 2,
                                                stream="numpy"))
    _assert_same(got, want)


def test_the_two_streams_differ_and_an_unknown_one_is_refused():
    x, y = _pool()
    a = next(moving_mnist._video_generator(x, y, 4, 8, 0)())[0]
    b = next(moving_mnist._video_generator(x, y, 4, 8, 0, "numpy")())[0]
    assert not np.array_equal(a, b)
    with pytest.raises(ValueError, match="stream"):
        moving_mnist._video_generator(x, y, 4, 8, 0, "cxx")


@pytest.mark.parametrize("loader", ["load_video", "load_image"])
def test_loaders_match_jax_from_one_pool(jax_native, monkeypatch, loader):
    pools = (_pool(60, 2), _pool(30, 3))
    monkeypatch.setattr(jax_mm, "_mnist_pool", lambda cla: pools)
    monkeypatch.setattr(moving_mnist, "_mnist_pool",
                        lambda cla, data_dir=None: pools)
    want = getattr(jax_mm, loader)(4, 8)
    got = getattr(moving_mnist, loader)(4, 8)
    for w, g in zip(want, got):
        _assert_same(_epochs(g), _epochs(w))


@pytest.mark.parametrize("seq_len", [16, 31])
def test_device_synthesizer_matches_jax_from_its_draws(seq_len):
    key = jax.random.PRNGKey(seq_len)
    digits = np.random.RandomState(4).rand(24, 28, 28).astype(np.float32)
    want = jax_dev.synthesize_videos(jnp.asarray(digits), key, seq_len)
    draws = {n: torch.from_numpy(np.array(jax.random.uniform(k, (24,))))
             for n, k in zip(("y", "x", "theta"), jax.random.split(key, 3))}
    got = dev_mm.synthesize_videos(torch.from_numpy(digits), None, seq_len,
                                   draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_video_sampler_matches_jax_and_keeps_labels_with_digits():
    pool = np.random.RandomState(5).rand(30, 28, 28).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[np.arange(30) % 10]
    key = jax.random.PRNGKey(3)
    want = jax_dev.make_video_sampler(4)(
        {"digits": jnp.asarray(pool), "labels": jnp.asarray(labels)}, key, 2,
        5)
    k_idx, k_traj = jax.random.split(key)
    draws = {"idx": torch.from_numpy(np.array(
        jax.random.randint(k_idx, (2, 5), 0, 30)))}
    draws.update({n: torch.from_numpy(np.array(jax.random.uniform(k, (10,))))
                  for n, k in zip(("y", "x", "theta"),
                                  jax.random.split(k_traj, 3))})
    data = {"digits": torch.from_numpy(pool),
            "labels": torch.from_numpy(labels)}
    got = dev_mm.make_video_sampler(4)(data, None, 2, 5, draws)
    assert got["x"].shape == (2, 5, 4, 4096) and got["y"].shape == (2, 5, 10)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # without draws: the generator's, labels still those of the digits
    gen = torch.Generator().manual_seed(0)
    out = dev_mm.make_video_sampler(4)(data, gen, 2, 5)
    first = out["x"][..., 0, :].reshape(10, 4096).sum(dim=1)
    mass = torch.from_numpy(pool).reshape(30, -1).sum(dim=1)
    idx = out["y"].reshape(10, 10).argmax(dim=1)
    # each video's first frame holds its digit's whole mass, and the digit's
    # index mod 10 is its label
    for f, c in zip(first, idx):
        cand = [i for i in range(int(c), 30, 10)]
        assert min(abs(float(f) - float(mass[i])) for i in cand) < 1e-3


@pytest.mark.parametrize("seq_len", [1, 4, 31, 8])
def test_chairs_epochs_match_jax(seq_len):
    kw = dict(size=8, num_dev=4, synthetic_size=14)
    want = jax_chairs.load(seq_len, 3, **kw)
    got = chairs.load(seq_len, 3, **kw)
    for w, g in zip(want, got):
        _assert_same(_epochs(g), _epochs(w))


def test_chairs_npy_matches_jax(tmp_path):
    arr = np.random.RandomState(6).randint(0, 256, (9, 31, 8, 8, 3))
    np.save(tmp_path / "chairs_8.npy", arr.astype(np.int32))
    kw = dict(size=8, data_dir=str(tmp_path), num_dev=3)
    for w, g in zip(jax_chairs.load(4, 2, **kw), chairs.load(4, 2, **kw)):
        _assert_same(_epochs(g), _epochs(w))
    with pytest.raises(FileNotFoundError):
        chairs.load(4, 2, size=16, data_dir=str(tmp_path),
                    synthetic_fallback=False)


# -- the trainer's dict batches ---------------------------------------------

def _tiny_trainer(tmp_path, **kw):
    _, tm, _, _ = models("moving_mnist", "local_ep", seq_len=3)
    return trainer_mod.Trainer(tm, outf=str(tmp_path), device="cpu",
                               checkpoint_every=0, **kw)


def test_resident_dict_data_share_one_index_draw(tmp_path):
    n = 12
    data = {"x": np.arange(n, dtype=np.float32)[:, None, None]
            * np.ones((1, 3, 4096), np.float32),
            "y": np.eye(n, dtype=np.float32)}
    tr = _tiny_trainer(tmp_path, resident_data=data)
    raw = tr.draw_batches(0)
    assert raw["x"].shape == (2, 2, 3, 4096) and raw["y"].shape == (2, 2, n)
    np.testing.assert_array_equal(raw["x"][..., 0, 0].numpy(),
                                  raw["y"].argmax(-1).float().numpy())
    seen = []

    def sampler(d, gen, nb, b):
        seen.append((sorted(d), nb, b))
        return {
            "x": d["x"][:nb * b].reshape(nb, b, 3, 4096),
            "y": d["y"][:nb * b].reshape(nb, b, n)}

    tr2 = _tiny_trainer(tmp_path / "s", resident_data=data,
                        batch_sampler=sampler)
    out = tr2.draw_batches(1)
    assert seen == [(["x", "y"], 2, 2)]
    assert torch.equal(out["y"][1, 0], torch.eye(n)[2])


def test_host_fed_dict_batches_and_dev_sweep(tmp_path, monkeypatch):
    _, tm, _, _ = models("moving_mnist", "local_ep", seq_len=3)
    rng = np.random.default_rng(0)
    batches = [raw_batch(tm.cfg, rng) for _ in range(5)]
    tr = trainer_mod.Trainer(tm, None, str(tmp_path), device="cpu",
                             checkpoint_every=0,
                             train_gen_factory=lambda: iter(batches),
                             dev_gen_factory=lambda: iter(batches))
    it = tr._host_batches()
    first = next(it)
    it.close()
    for k in ("x", "y"):
        np.testing.assert_array_equal(
            first[k].numpy(), np.stack([batches[0][k], batches[1][k]]))
    tr.state = tr.init_state(tm.init(0, "cpu"))
    gens, recs = tr.dev_costs(99)
    assert gens.shape == (5,) and recs is None and np.isfinite(gens).all()
    # a dev set over the cap keeps the batches that fit
    one = sum(a.nbytes for a in batches[0].values())
    monkeypatch.setattr(trainer_mod, "DEV_RESIDENT_MAX", 2 * one + 1)
    tr._dev_data = None
    gens, _ = tr.dev_costs(99)
    assert gens.shape == (2,)
