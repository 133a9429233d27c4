"""The port's throughput tools on the CPU at tiny widths, end to end:
``bench_families`` (its three records), ``bench_serving`` (an image family,
the video family, an inference-side entry) and ``bench_server`` (2 HTTP
clients against the port's server): JAX's metric names and keys, finite
positive numbers, no device number from a CPU run; and each CLI refuses
to run without a card.
"""

import json
import math

import pytest
import torch

from graphical_gan_tpu_torch.tools import (
    bench_families, bench_server, bench_serving)
from _torch_threads import one_thread  # noqa: F401

TINY = ["--dim", "4", "--device", "cpu"]


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_bench_families(capsys):
    out = bench_families.main(["--families", "gmgan", "ssgan",
                               "ssgan_device", "--batch-size", "2",
                               "--rounds", "1", "--iters", "1",
                               "--data-rows", "16"] + TINY)
    assert _lines(capsys) == out
    assert [(r["metric"], r["unit"]) for r in out] == [
        ("gmgan_cifar10_local_ep_train_throughput", "images/sec/chip"),
        ("ssgan_moving_mnist_local_ep_train_throughput", "frames/sec/chip"),
        ("ssgan_moving_mnist_device_synthesis_train_throughput",
         "frames/sec/chip")]
    for r in out:
        assert math.isfinite(r["value"]) and r["value"] > 0
        assert r["sec_per_iter"] > 0 and r["dtype"] == "bfloat16"
        # a CPU run measures no device time
        assert r["device_ms"] is None and r["busy_share"] is None
        assert r["device_kind"] == "cpu"
    # images per iteration as bench.py counts them, (1 + k) B (x LEN)
    gmgan, ssgan = out[0], out[1]
    assert gmgan["value"] * gmgan["sec_per_iter"] == pytest.approx(2 * 2)
    assert ssgan["value"] * ssgan["sec_per_iter"] == pytest.approx(
        2 * 2 * 16)


@pytest.mark.parametrize("families, entry", [
    ("gan_inference,ssgan", "sampler"), ("gmgan", "cluster"),
    ("ssgan", "reconstructor")])
def test_bench_serving(capsys, families, entry):
    assert bench_serving.main(["--families", families, "--entry", entry,
                               "--batches", "2,3", "--depth", "2",
                               "--rounds", "1"] + TINY) == 0
    recs = _lines(capsys)
    assert [(r["metric"].split("_serving")[0], r["batch"]) for r in recs] \
        == [(f if entry == "sampler" else f"{f}_{entry}", b)
            for f in families.split(",") for b in (2, 3)]
    for r in recs:
        assert r["latency_ms"] > 0 and r["pipeline_depth"] == 2
        assert r["samples_per_sec"] == pytest.approx(
            r["batch"] / r["latency_ms"] * 1e3)
        video = r["metric"].startswith("ssgan")
        assert ("frames_per_sec" in r) == video
        if video:
            assert r["frames_per_sec"] == pytest.approx(
                16 * r["samples_per_sec"])


def test_bench_server(capsys):
    assert bench_server.main(["--request-sizes", "1,3", "--clients", "2",
                              "--requests-per-client", "3", "--buckets",
                              "2,4"] + TINY) == 0
    recs = _lines(capsys)
    assert [r["request_size"] for r in recs] == [1, 3]
    for r in recs:
        assert r["metric"] == "gan_inference_server_throughput"
        assert r["requests"] == 6 and r["clients"] == 2
        assert r["samples_per_sec"] > 0
        assert 0 < r["latency_ms_p50"] <= r["latency_ms_p95"] \
            <= r["latency_ms_max"]
        assert 0 < r["fill_ratio"] <= 1 and r["batches"] >= 1
        assert r["rows_per_batch"] > 0 and r["buckets"] == [2, 4]
        assert r["device_kind"] == "cpu"


@pytest.mark.parametrize("main, argv", [
    (bench_families.main, ["--families", "gmgan"]),
    (bench_serving.main, ["--families", "gan_inference"]),
    (bench_server.main, ["--request-sizes", "1"])])
def test_cli_without_a_card_raises(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + ["--dim", "4"])
