"""Artifact export (``graphical_gan_tpu_torch/serve/export.py``) of family
1 on the CPU (families 2 and 3: ``tests/test_torch_export_families.py``).

Each entry of ``ENTRIES["gan_inference"]`` (mnist vae, whose encoder draws
its posterior eps), the int8 sampler and celeba ali's encoder (its
dequantization noise) are exported with a symbolic batch
(``torch.export``), loaded back and called at batch 3 and batch 8: the
outputs equal the run directory's call (``serve/server.py:
sampler_from_run_dir``) bit for bit, the seeded draws made by the loader
outside the program. Three of the programs (both kinds of draw, the int8
path, K1's convs) are also called in a process that imports
``graphical_gan_tpu_torch.ops.kernels`` and no model code. A program
exported on the CPU holds the kernels' plain versions as aten ops (the
wrappers take them for CPU tensors); one exported on the card holds the
``ggan::`` ops, which ``chip_smoke.py``'s int8-export phase serves from a
fresh process. The server serves an export directory over HTTP; the CLI
exports a fixed batch.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from graphical_gan_tpu_torch.serve.export import (
    ENTRIES, export_entry, export_sampler, load_sampler, main as export_main)
from graphical_gan_tpu_torch.serve.server import (
    sampler_from_run_dir, serve_run_dir)

import _torch_export as ex
from _torch_threads import one_thread  # noqa: F401

CASES = ([("gan_inference", e, None) for e in ENTRIES["gan_inference"]]
         + [("gan_inference", "sampler", "int8"),
            ("celeba", "encoder", None)])
# the int8 sampler (Q1, Q2, K2a, K2b), the encoders (K1) and both kinds of
# draw (vae's normal eps, celeba's uniform dequantization noise)
BARE = [("gan_inference", "sampler", "int8"),
        ("gan_inference", "encoder", None), ("celeba", "encoder", None)]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    base = tmp_path_factory.mktemp("export")
    return ex.export_cases(base, CASES), base


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_exported_entry_equals_the_run_dir_call(exported, case):
    ex.check_case(*exported[0][case], case)


def test_programs_run_with_the_kernel_ops_alone(exported, tmp_path):
    """The BARE programs, with the draws their manifests name made by hand,
    in a process that imports only ``graphical_gan_tpu_torch.ops.kernels``
    (and so the ops layer under it): no model, serving or training code."""
    cases = []
    for i, case in enumerate(BARE):
        info, ref = exported[0][case]
        arrays = {}
        for n, (inputs, want) in ref.items():
            arrays.update({f"{n}_in{j}": a for j, a in enumerate(inputs)})
            arrays[f"{n}_out"] = want
        data = str(tmp_path / f"{i}.npz")
        np.savez(data, **arrays)
        cases.append({"dir": os.path.dirname(info["blob"]), "data": data,
                      "seed": ex.SEED, "batches": list(ref)})
    spec = str(tmp_path / "cases.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=ex.ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", ex._BARE, spec], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["ok", str(len(BARE))]


def test_server_serves_an_export_dir(exported):
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    info, ref = exported[0][("gan_inference", "sampler", "int8")]
    export_dir = os.path.dirname(info["blob"])
    httpd, batcher, identity, _ = serve_run_dir(
        export_dir=export_dir, buckets=(4, 8), port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert identity["backend"] == "export"
        assert identity["quantization"] == "int8"
        assert identity["symbolic_batch"] is True
        client = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        assert client.healthz()["backend"] == "export"
        out = client.sample(n=6, seed=2)
        assert out.shape == (6, 784) and np.isfinite(out).all()
        inputs, want = ref[3]
        got = client.sample(inputs=inputs, seed=ex.SEED, exact=True)
        np.testing.assert_array_equal(got, want)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    from graphical_gan_tpu_torch.serve.server import main
    with pytest.raises(SystemExit):
        main(["--export-dir", export_dir, "--quantize", "int8"])


def test_export_cli_and_fixed_batch(exported, capsys):
    base = exported[1]
    run = str(base / "gan_inference")
    assert export_main(["--run-dir", run, "--device", "cpu",
                        "--fixed-batch", "--out", str(base / "fixed")]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["symbolic_batch"] is False
    assert info["fixed_batch_reason"] == "a fixed batch was asked for"
    dl = ex.RUNS["gan_inference"][1].dim_latent
    assert info["inputs"] == [{"shape": [4, dl], "dtype": "float32",
                               "prior": "normal"}]
    call = load_sampler(info["blob"])
    z = np.random.default_rng(0).standard_normal((4, dl), dtype=np.float32)
    want = sampler_from_run_dir(run, device="cpu")[0](1, z)
    np.testing.assert_array_equal(call(1, z).numpy(), want)
    with pytest.raises(ValueError, match="sampler entry only"):
        export_sampler(run, entry="encoder", quantize="int8", device="cpu",
                       out=str(base / "refused"))


@pytest.mark.parametrize("refusal", ["symbolic dimension", "other error"])
def test_only_a_symbolic_refusal_falls_back(monkeypatch, refusal):
    """``export_entry`` exports the example batch only where
    ``torch.export`` refuses the symbolic batch, and says why; any other
    error of the export is raised, not turned into a fixed-batch
    program."""
    import torch
    from torch._dynamo.exc import UserError, UserErrorType
    cls, cfg = ex.RUNS["gan_inference"]
    model = cls(cfg)
    params = model.init(0, "cpu")
    real = torch.export.export

    def export(program, args, dynamic_shapes=None, **kw):
        if dynamic_shapes is None:
            return real(program, args, **kw)
        if refusal == "other error":
            raise RuntimeError("a tracing bug")
        raise UserError(UserErrorType.CONSTRAINT_VIOLATION,
                        "Constraints violated (batch)!\n"
                        "  - batch was specialized to 4")
    monkeypatch.setattr(torch.export, "export", export)
    if refusal == "other error":
        with pytest.raises(RuntimeError, match="a tracing bug"):
            export_entry("gan_inference", model, params)
        return
    with pytest.warns(UserWarning, match="exported at the fixed batch 4"):
        program, _, why = export_entry("gan_inference", model, params)
    assert why == ("UserError: Constraints violated (batch)! - batch was "
                   "specialized to 4")
    z = torch.zeros(4, cfg.dim_latent)
    assert program.module()(z).shape[0] == 4
