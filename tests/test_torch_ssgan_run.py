"""The SSGAN entry points, hook, serving and tools on the CPU
(``graphical_gan_tpu_torch/runs/ssgan.py``, ``serve/``,
``tools/generate.py``, ``report/save_images.py``) at dim 4, B 2, LEN 3,
with small digit pools: both aliases train through each data pipeline and
resume, the hook writes its montages (sizes read from the PNG header) and
GIFs and logs ``dev rec l2``; without ``--device cpu`` the entry refuses
to start on a machine without a card; the sampler (server-drawn priors)
and the reconstructor (video and label rows) over HTTP, the reconstructor
equal to the model's own forward; the generate tool's six artifacts; and
the stdlib GIF89a writer read back by imageio (frame count, size, every
pixel; RGB on its 3-3-2 palette).
"""

import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.core.config import asdict, ssgan_defaults
from graphical_gan_tpu_torch.data import chairs as chairs_data
from graphical_gan_tpu_torch.data import moving_mnist
from graphical_gan_tpu_torch.models.ssgan import SSGanModel
from graphical_gan_tpu_torch.report.save_images import (
    _gif_palette, gif_indices, large_image, png_size, save_gifs)
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
from _torch_threads import one_thread  # noqa: F401

TINY = ["--dim", "4", "--batch-size", "2", "--seq-len", "3", "--device",
        "cpu", "--eval-every", "2", "--checkpoint-every", "2"]
ARTIFACTS = ("samples", "reconstruction", "disentangle")


@pytest.fixture
def small_pools(monkeypatch):
    """MNIST pools of 24 train and 12 test digits, chairs of 10."""
    rng = np.random.RandomState(0)
    pools = ((rng.rand(24, 28, 28).astype(np.float32), rng.randint(0, 10, 24)),
             (rng.rand(12, 28, 28).astype(np.float32), rng.randint(0, 10, 12)))
    monkeypatch.setattr(moving_mnist, "_mnist_pool",
                        lambda cla, data_dir=None: pools)
    monkeypatch.setattr(chairs_data, "load", functools.partial(
        chairs_data.load, num_dev=4, synthetic_size=10))


def _log(run_dir):
    with open(os.path.join(run_dir, "logfile.txt")) as f:
        return f.read()


@pytest.mark.parametrize("pipeline", ["host", "resident", "device"])
def test_moving_mnist_cli_trains_with_its_hook_and_resumes(
        tmp_path, small_pools, pipeline, capsys):
    from graphical_gan_tpu_torch.runs.ssgan_inference_moving_mnist import (
        main)
    run_dir = str(tmp_path / "run")
    common = TINY + ["--run-dir", run_dir, "--data-pipeline", pipeline,
                     "--pos-mode", "gsp"]
    main(common + ["--iters", "3"])
    out = capsys.readouterr().out
    assert "Number of parameters in each player [" in out
    assert "iter 2\t" in out and "dev rec l2" in _log(run_dir)
    files = set(os.listdir(run_dir))
    assert {f"{a}_1.{e}" for a in ARTIFACTS for e in ("png", "gif")} \
        | {"ckpt_1.npz", "ckpt_2.npz", "config.json"} <= files
    # rows are videos, columns frames: 2 sample videos, 2 x 2 interleaved
    assert png_size(os.path.join(run_dir, "samples_1.png")) == \
        (3 * 64, 2 * 64, 0)
    assert png_size(os.path.join(run_dir, "reconstruction_1.png")) == \
        (3 * 64, 4 * 64, 0)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["pos_mode"], cfg["seq_len"], cfg["dim"]) == ("gsp", 3, 4)
    main(common + ["--iters", "5"])
    out = capsys.readouterr().out
    assert "iter 2\t" not in out and "iter 4\t" in out


def test_chairs_cli_trains_unconditional_videos(tmp_path, small_pools):
    from graphical_gan_tpu_torch.runs.ssgan_inference_chairs import main
    run_dir = str(tmp_path / "run")
    main(TINY + ["--run-dir", run_dir, "--iters", "2", "--mode", "ali",
                 "--ali-mode", "3dcnn", "--data-pipeline", "resident"])
    log = _log(run_dir)
    assert "iter 1\t" in log and "dev rec l2" in log
    # RGB frames: the color type is 2
    assert png_size(os.path.join(run_dir, "samples_1.png")) == \
        (3 * 64, 2 * 64, 2)


def test_entry_points_refuse_a_missing_card_and_bad_pipelines(tmp_path):
    from graphical_gan_tpu_torch.runs import ssgan
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ssgan.main(["--iters", "1", "--outdir", str(tmp_path)])
    with pytest.raises(ValueError, match="moving-mnist"):
        ssgan.run("chairs", data_pipeline="device", device="cpu")
    with pytest.raises(ValueError, match="data_pipeline"):
        ssgan.run(data_pipeline="disk", device="cpu")


def _run_dir(path):
    cfg = ssgan_defaults("moving_mnist", "local_ep", dim=4, batch_size=4,
                         seq_len=3, pos_mode="inverse")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(asdict(cfg), f)
    model = SSGanModel(cfg)
    params = model.init(seed=0, device="cpu")
    ckpt_lib.save_params(os.path.join(path, "ckpt_3.npz"), params,
                         {"iteration": 3})
    return cfg, model, params


def test_sampler_and_reconstructor_over_http(tmp_path):
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import (
        BatchingSampler, make_http_server, sampler_from_run_dir)
    cfg, model, params = _run_dir(str(tmp_path / "run"))
    servers = {}
    for entry in ("sampler", "reconstructor"):
        call, kinds, shapes, ident = sampler_from_run_dir(
            str(tmp_path / "run"), entry=entry, device="cpu")
        want_kinds = {"sampler": ["normal", "normal", "onehot"],
                      "reconstructor": ["image", "onehot"]}[entry]
        assert kinds == want_kinds
        b = BatchingSampler(call, kinds, shapes, buckets=(4, 8),
                            max_wait_ms=20.0)
        httpd = make_http_server(b, ident, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers[entry] = (httpd, b)
    try:
        url = "http://127.0.0.1:{}"
        sam = SamplerClient(url.format(
            servers["sampler"][0].server_address[1]))
        assert sam.healthz()["family"] == "ssgan"
        vid = sam.sample(n=6, seed=2)
        assert vid.shape == (6, 3, 4096) and np.abs(vid).max() <= 1.0
        rec = SamplerClient(url.format(
            servers["reconstructor"][0].server_address[1]))
        rng = np.random.default_rng(0)
        x = rng.random((8, 3, 4096), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
        got = rec.sample(inputs=[x, y], seed=1, exact=True)
        with torch.no_grad():
            want = model.reconstruct(params, torch.from_numpy(x),
                                     torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rec.sample(inputs=[x, y], seed=1),
                                      want)
    finally:
        for httpd, b in servers.values():
            httpd.shutdown()
            httpd.server_close()
            b.close()


def test_generate_writes_the_ssgan_montages_and_gifs(tmp_path, small_pools,
                                                     capsys):
    from graphical_gan_tpu_torch.tools.generate import main
    run_dir = str(tmp_path / "run")
    _run_dir(run_dir)
    info = main(["--run-dir", run_dir, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == info
    assert (info["family"], info["iteration"]) == ("ssgan", 3)
    assert sorted(info["artifacts"]) == sorted(
        f"{a}_3.{e}" for a in ARTIFACTS for e in ("gif", "png"))
    assert png_size(os.path.join(info["outdir"], "disentangle_3.png")) == \
        (3 * 64, 8 * 64, 0)
    with pytest.raises(ValueError, match="dev batch"):
        main(["--run-dir", run_dir, "--device", "cpu", "--no-data"])


@pytest.mark.parametrize("channels", [1, 3])
def test_gif_reads_back_frame_for_frame(tmp_path, channels):
    imageio = pytest.importorskip("imageio")
    x = np.random.default_rng(channels).random(
        (6, 5, channels, 16, 16), dtype=np.float32)
    path = save_gifs(x, str(tmp_path / "v.gif"))
    frames = imageio.mimread(path)
    assert len(frames) == 5
    for t, f in enumerate(frames):
        f = np.asarray(f)
        want = large_image(x[:, t])          # 2 x 3 grid of 16x16
        assert f.shape[:2] == (32, 48)
        if channels == 1:
            got = f if f.ndim == 2 else f[..., 0]
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(f[..., :3],
                                          _gif_palette(True)[gif_indices(
                                              want)])


def test_learning_protocol_reads_its_dev_rec_l2(tmp_path):
    """``tools/ssgan_learn``: the hook before training and at each cadence,
    the readings parsed from the logfile by its labels (the one before
    training at 0, the last at ``iters``; every iteration under 5 is
    flushed, so the one after 2 reads at 2), at the tests' widths."""
    from graphical_gan_tpu_torch.tools.ssgan_learn import (
        dev_rec_readings, run_protocol)
    tr, recs, metrics = run_protocol(
        seed=0, iters=4, every=2, outdir=str(tmp_path), device="cpu",
        compute_dtype="float32", dim=4, batch_size=2, seq_len=3)
    assert sorted(recs) == [0, 2, 4]
    assert all(np.isfinite(v) and v > 0 for v in recs.values())
    assert set(metrics) == {"gen_cost", "disc_cost"}
    assert dev_rec_readings("iter 7\ttime\t0.1\tdev rec l2\t0.25\n"
                            "iter 8\ttime\t0.1\n") == {7: 0.25}
