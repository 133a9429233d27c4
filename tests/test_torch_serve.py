"""The port's serving path (graphical_gan_tpu_torch/serve) on the CPU.

- A run directory written by the JAX package (``ckpt_lib.save`` of a whole
  TrainState) serves the same outputs through the port's
  ``sampler_from_run_dir(..., device="cpu")`` as through the JAX server's
  (f32 atol 1e-4).
- The batcher and HTTP cases of tests/test_server.py, on the port:
  coalescing and stats, padding, straddling, exact mode, the HTTP front and
  the stdlib client, image entries, input validation.
- The default device is the card: without CUDA it raises. On the CPU the
  kernel wrappers run their plain versions and count no launches.
"""

import json
import os
import threading
import urllib.error
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.core.config import (
    asdict as port_asdict, gan_inference_defaults)
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.ops import kernels
from graphical_gan_tpu_torch.serve.client import SamplerClient
from graphical_gan_tpu_torch.serve.export import ENTRY_OUTPUT
from graphical_gan_tpu_torch.serve.server import (
    BatchingSampler, make_http_server, sampler_from_run_dir, serve_run_dir)
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib


def _port_run_dir(path, dataset="svhn", mode="ali", seed=0):
    """A run directory made by the port alone (params-only checkpoint);
    svhn/ali has BN off, so rows are independent of their co-batched rows
    and padding is checkable bit for bit."""
    cfg = gan_inference_defaults(dataset, mode, dim=8, batch_size=8)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(port_asdict(cfg), f)
    model = GanInferenceModel(cfg)
    params = model.init(seed=seed, device="cpu")
    ckpt_lib.save_params(os.path.join(path, "ckpt_2.npz"), params,
                         {"iteration": 2})
    return cfg, model, params


def _batcher(call, kinds, shapes, **kw):
    kw.setdefault("buckets", (4, 8))
    kw.setdefault("max_wait_ms", 40.0)
    return BatchingSampler(call, kinds, shapes, **kw)


@pytest.fixture
def sampler(tmp_path):
    cfg, model, params = _port_run_dir(str(tmp_path / "run"))
    call, kinds, shapes, ident = sampler_from_run_dir(
        str(tmp_path / "run"), entry="sampler", device="cpu")
    return cfg, model, params, call, kinds, shapes, ident


def _direct_sample(model, params, noise):
    with torch.inference_mode():
        return model.sample(params, torch.from_numpy(noise)).numpy()


@pytest.mark.parametrize("entry", ["sampler", "encoder", "reconstructor"])
def test_jax_run_dir_serves_same_outputs(tmp_path, entry):
    import jax
    from graphical_gan_tpu.core.config import gan_inference_defaults as jcfg
    from graphical_gan_tpu.models.gan_inference import GanInferenceModel as J
    from graphical_gan_tpu.serve.server import (
        sampler_from_run_dir as jax_sampler_from_run_dir)
    from graphical_gan_tpu.train import checkpoint as jax_ckpt
    from graphical_gan_tpu.train.step import make_train_step

    cfg = jcfg("cifar10", "wali-gp", dim=8, batch_size=8)  # BN on
    model = J(cfg)
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(asdict(cfg), f, default=str)
    _, init_state = make_train_step(model, jit=False)
    jax_ckpt.save(os.path.join(run_dir, "ckpt_5.npz"),
                  init_state(model.init(jax.random.PRNGKey(3))),
                  {"iteration": 5})

    jcall, jkinds, jshapes, jident = jax_sampler_from_run_dir(
        run_dir, entry=entry)
    pcall, pkinds, pshapes, pident = sampler_from_run_dir(
        run_dir, entry=entry, device="cpu")
    assert pkinds == jkinds and pshapes == jshapes
    for key in ("family", "entry", "output", "checkpoint", "iteration"):
        assert pident[key] == jident[key]
    rng = np.random.default_rng(0)
    if entry == "sampler":
        x = rng.standard_normal((6, cfg.dim_latent)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (6, cfg.data.output_dim)).astype(np.float32)
    want = np.asarray(jcall(jax.random.PRNGKey(0), x))
    got = pcall(0, x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_coalescing_and_stats_accounting(sampler):
    cfg, model, params, call, kinds, shapes, _ = sampler
    # a wide window, so a loaded test host still coalesces the six threads
    b = _batcher(call, kinds, shapes, max_wait_ms=200.0)
    try:
        b.warmup()
        results = {}

        def worker(i, n):
            results[i] = b.submit(n=n, seed=i).wait(timeout=120)

        sizes = [1, 2, 1, 3, 2, 1]
        threads = [threading.Thread(target=worker, args=(i, n))
                   for i, n in enumerate(sizes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, n in enumerate(sizes):
            assert results[i].shape == (n, cfg.data.output_dim)
        s = b.snapshot()
        assert s["requests"] == len(sizes)
        assert s["rows"] == sum(sizes)
        dispatched = sum(int(k) * v for k, v in s["bucket_hist"].items())
        assert dispatched == s["rows"] + s["padded_rows"]
        assert s["batches"] < s["requests"]
        assert 0 < s["fill_ratio"] <= 1
        assert "latency_ms_p50" in s and "latency_ms_p95" in s
    finally:
        b.close()


def test_padding_bit_exact_when_rows_independent(sampler):
    cfg, model, params, call, kinds, shapes, _ = sampler
    b = _batcher(call, kinds, shapes)
    try:
        noise = np.random.RandomState(3).randn(3, cfg.dim_latent).astype(
            np.float32)
        out = b.submit(inputs=[noise]).wait(timeout=120)
        np.testing.assert_array_equal(out, _direct_sample(model, params,
                                                          noise))
        assert b.snapshot()["padded_rows"] == 1  # 3 rows -> bucket 4
    finally:
        b.close()


def test_request_straddles_device_batches(sampler):
    cfg, model, params, call, kinds, shapes, _ = sampler
    b = _batcher(call, kinds, shapes)  # max bucket 8
    try:
        noise = np.random.RandomState(4).randn(11, cfg.dim_latent).astype(
            np.float32)
        out = b.submit(inputs=[noise]).wait(timeout=120)
        assert out.shape[0] == 11
        np.testing.assert_array_equal(out, _direct_sample(model, params,
                                                          noise))
        s = b.snapshot()
        assert s["batches"] == 2  # 8 + 3->4
        assert s["padded_rows"] == 1
    finally:
        b.close()


def test_exact_mode_reproducible(sampler):
    _, _, _, call, kinds, shapes, _ = sampler
    b = _batcher(call, kinds, shapes)
    try:
        a = b.sample_exact(n=5, seed=42)
        c = b.sample_exact(n=5, seed=42)
        np.testing.assert_array_equal(a, c)
        assert not np.array_equal(a, b.sample_exact(n=5, seed=43))
        assert b.snapshot()["exact_requests"] == 3
    finally:
        b.close()


def test_prior_padding_under_batch_statistics(tmp_path):
    """With BN on (cifar10), a row depends on its co-batched rows: a padded
    dispatch differs from a solo one, and padding draws come from the
    prior (finite, not zeros) and change with the dispatch counter."""
    cfg, model, params = _port_run_dir(str(tmp_path / "run"), "cifar10",
                                       "wali-gp")
    assert cfg.bn
    noise = np.random.RandomState(0).randn(8, cfg.dim_latent).astype(
        np.float32)
    full = _direct_sample(model, params, noise)
    sub = _direct_sample(model, params, noise[:3])
    assert not np.allclose(full[:3], sub, atol=1e-5)
    call, kinds, shapes, _ = sampler_from_run_dir(str(tmp_path / "run"),
                                                  device="cpu")
    b = _batcher(call, kinds, shapes)
    try:
        first = b.submit(inputs=[noise[:3]]).wait(timeout=120)
        second = b.submit(inputs=[noise[:3]]).wait(timeout=120)
        assert np.isfinite(first).all() and first.shape == (3, 3072)
        assert not np.array_equal(first, second)  # other pad draws
        np.testing.assert_array_equal(b.sample_exact(inputs=[noise[:3]]),
                                      sub)  # exact: alone, unpadded
    finally:
        b.close()


def test_http_roundtrip_and_error_path(sampler):
    cfg, model, params, call, kinds, shapes, _ = sampler
    b = _batcher(call, kinds, shapes)
    httpd = make_http_server(b, {"family": "gan_inference"}, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        cl = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        h = cl.healthz()
        assert h["ok"] and h["family"] == "gan_inference"
        assert cl.sample(n=2, seed=7).shape[0] == 2
        noise = np.random.RandomState(5).randn(3, cfg.dim_latent).astype(
            np.float32)
        np.testing.assert_array_equal(cl.sample(inputs=[noise]),
                                      _direct_sample(model, params, noise))
        e1 = cl.sample(n=4, seed=9, exact=True)
        np.testing.assert_array_equal(e1, cl.sample(n=4, seed=9, exact=True))
        e3 = cl.sample(inputs=[noise], seed=1, exact=True)
        np.testing.assert_array_equal(e3, _direct_sample(model, params,
                                                         noise))
        s = cl.stats()
        assert s["requests"] >= 2 and s["exact_requests"] == 3
        bad = urllib.request.Request(
            cl.base + "/sample", data=b"{\"n\": \"x\"}", method="POST",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read().decode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(cl.base + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        b.close()


def test_image_entry_batched_serving(tmp_path):
    cfg, model, params = _port_run_dir(str(tmp_path / "run"))
    call, kinds, shapes, ident = sampler_from_run_dir(
        str(tmp_path / "run"), entry="reconstructor", device="cpu")
    assert kinds == ["image"] and ident["output"] == "images"
    b = _batcher(call, kinds, shapes, max_wait_ms=20.0)
    try:
        b.warmup()  # zero-image warmup inputs run every bucket
        raw = np.random.RandomState(0).randint(
            0, 256, size=(3, cfg.data.output_dim)).astype(np.float32)
        out = b.submit(inputs=[raw]).wait(timeout=120)
        with torch.inference_mode():
            direct = model.reconstruct(params, torch.from_numpy(raw)).numpy()
        np.testing.assert_allclose(out, direct, atol=1e-5)
        assert b.snapshot()["padded_rows"] == 1  # cycled row, BN off
        np.testing.assert_array_equal(b.sample_exact(inputs=[raw], seed=9),
                                      b.sample_exact(inputs=[raw], seed=9))
        with pytest.raises(ValueError, match="npz payload"):
            b.submit(n=2, seed=0)
        with pytest.raises(ValueError, match="npz payload"):
            b.sample_exact(n=2, seed=0)
    finally:
        b.close()


def test_input_validation_surfaces(sampler):
    cfg, _, _, call, kinds, shapes, _ = sampler
    b = _batcher(call, kinds, shapes)
    try:
        with pytest.raises(ValueError):
            b.submit(inputs=[np.zeros((2, cfg.dim_latent + 1), np.float32)])
        with pytest.raises(ValueError):
            b.submit()
        with pytest.raises(ValueError, match="zero rows"):
            b.submit(inputs=[np.zeros((0, cfg.dim_latent), np.float32)])
        with pytest.raises(ValueError, match="zero rows"):
            b.sample_exact(inputs=[np.zeros((0, cfg.dim_latent),
                                            np.float32)])
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(n=1)


def test_http_response_keyed_by_entry_output(tmp_path):
    """encoder -> 'latents', with 'images' kept as an alias."""
    import io
    cfg, _, _ = _port_run_dir(str(tmp_path / "run"))
    httpd, b, ident, warmup_s = serve_run_dir(
        str(tmp_path / "run"), entry="encoder", device="cpu",
        buckets=(4, 8), port=0)
    assert ident["output"] == ENTRY_OUTPUT["encoder"] == "latents"
    assert warmup_s is not None
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        raw = np.random.RandomState(0).randint(
            0, 256, size=(2, cfg.data.output_dim)).astype(np.float32)
        buf = io.BytesIO()
        np.savez(buf, input0=raw)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/sample",
            data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as r:
            meta = json.loads(r.headers["X-GGAN-Meta"])
            data = np.load(io.BytesIO(r.read()))
        assert meta["output"] == "latents" and meta["mode"] == "batched"
        assert set(data.files) == {"latents", "images"}
        assert data["latents"].shape == (2, cfg.dim_latent)
        cl = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        np.testing.assert_array_equal(cl.sample(inputs=[raw]),
                                      data["latents"])
        assert cl.healthz()["entry"] == "encoder"
    finally:
        httpd.shutdown()
        httpd.server_close()
        b.close()


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _port_run_dir(str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampler_from_run_dir(str(tmp_path / "run"))
    from graphical_gan_tpu_torch.serve.server import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--run-dir", str(tmp_path / "run"), "--no-warmup"])


def test_cpu_serving_launches_no_kernel(tmp_path):
    _port_run_dir(str(tmp_path / "run"), "cifar10", "wali-gp")
    kernels.reset_launches()
    call, _, _, _ = sampler_from_run_dir(str(tmp_path / "run"),
                                         entry="reconstructor", device="cpu")
    out = call(0, np.zeros((4, 3072), np.float32))
    assert out.shape == (4, 3072) and np.isfinite(out).all()
    assert kernels.launches() == {"fused_conv2d_bias_act": 0, "bn_stats": 0,
                                  "bn_apply": 0, "bn_bwd": 0,
                                  "conv_gemm_taps": 0,
                                  "conv_gemm_im2col": 0,
                                  "quantize_int8": 0, "int8_conv": 0,
                                  "bn_apply_q8": 0}


def test_checkpoint_round_trip_and_latest(tmp_path):
    cfg, model, params = _port_run_dir(str(tmp_path / "run"))
    ckpt_lib.save_params(str(tmp_path / "run" / "ckpt_10.npz"), params,
                         {"iteration": 10})
    (tmp_path / "run" / "ckpt_best.npz").write_bytes(b"")  # ignored name
    assert [s for s, _ in ckpt_lib.list_checkpoints(str(tmp_path / "run"))] \
        == [2, 10]
    path = ckpt_lib.latest(str(tmp_path / "run"))
    assert path.endswith("ckpt_10.npz")
    flat, extra = ckpt_lib.load_raw(path)
    assert extra == {"iteration": 10}
    back = ckpt_lib.params_from_jax(ckpt_lib.params_of(flat), "cpu")
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k])
    assert ckpt_lib.latest(str(tmp_path / "missing")) is None
