"""The server's ``--dp-devices`` (``graphical_gan_tpu_torch/serve/
server.py: DataParallelEntry``, JAX ``serve/server.py:158-168, 396-455,
584-617``) on 2 gloo ranks on the CPU, a cifar10 wali-gp run directory
(BN in G) at dim 8: each dispatch's rows split over the ranks with the
batch statistics over the whole dispatched batch, so a dispatch equals
the one-rank server's on the same seed and inputs, float and int8
(``--quantize int8``: K2b writes the int8 copy from the merged
statistics), within 2e-6 (the statistics summed in another order; on the
CPU the split kernels run their plain versions, f64 sums); the batcher
pads a 5-row request to the bucket and rank 0 gathers the rows in order;
every bucket and every exact-mode request must divide by the ranks;
``--export-dir`` refuses ``--dp-devices``.
"""

import json
import os

import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from graphical_gan_tpu_torch.core.config import (
    asdict as port_asdict, gan_inference_defaults)
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.serve import server
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

QUANT = (None, "int8")
TOL = 2e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import _torch_dist
    path = str(tmp_path_factory.mktemp("dp") / "run")
    cfg = gan_inference_defaults("cifar10", "wali-gp", dim=8, batch_size=8)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(port_asdict(cfg), f)
    model = GanInferenceModel(cfg)
    ckpt_lib.save_params(os.path.join(path, "ckpt_3.npz"),
                         model.init(seed=0, device="cpu"), {"iteration": 3})
    rng = np.random.default_rng(0)
    requests = [(5, (rng.standard_normal((8, cfg.dim_latent))
                     .astype(np.float32),)),
                (9, (rng.standard_normal((16, cfg.dim_latent))
                     .astype(np.float32),))]
    job = _torch_dist.start("server_dp_worker", 2,
                            {"run_dir": path, "quantize": QUANT,
                             "requests": requests})
    ref = {}
    for q in QUANT:
        call, kinds, shapes, _ = server.sampler_from_run_dir(
            path, device="cpu", quantize=q)
        batcher = server.BatchingSampler(call, kinds, shapes, buckets=(8,))
        try:
            batched = batcher.submit(n=5, seed=3).wait(60)
        finally:
            batcher.close()
        ref[str(q)] = {"outs": [call(s, *x) for s, x in requests],
                       "batched": batched}
    return job.join(), ref


@pytest.mark.parametrize("q", [str(q) for q in QUANT])
def test_dispatch_equals_one_rank(run, q):
    ranks, ref = run
    got = ranks[0][q]
    for a, b in zip(got["outs"], ref[q]["outs"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["batched"], ref[q]["batched"], atol=TOL,
                               rtol=0)
    assert got["identity"]["dp_devices"] == 2
    assert got["identity"]["quantization"] == (q if q != "None" else "none")


def test_the_other_rank_served_every_dispatch(run):
    ranks, _ = run
    # 2 requests and the batcher's one dispatch, per quantization
    assert [ranks[1][str(q)]["served"] for q in QUANT] == [3, 3]


def test_buckets_and_exact_requests_must_divide():
    with pytest.raises(ValueError, match="divisible"):
        server.BatchingSampler(lambda s, *x: x[0], ["normal"], [(8, 4)],
                               buckets=(8, 6), dp_devices=4)
    b = server.BatchingSampler(lambda s, *x: x[0], ["normal"], [(8, 4)],
                               buckets=(8,), dp_devices=2)
    try:
        with pytest.raises(ValueError, match="dp_devices"):
            b.sample_exact(n=3, seed=0)
        assert b.sample_exact(n=4, seed=0).shape == (4, 4)
    finally:
        b.close()


def test_export_dir_refuses_dp_devices(tmp_path):
    with pytest.raises(SystemExit):
        server.main(["--export-dir", str(tmp_path), "--dp-devices", "2"])
