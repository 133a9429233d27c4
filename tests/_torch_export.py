"""Shared parts of the export tests (``tests/test_torch_export*.py``):
small run directories of the three families, the cases' exports and their
run-directory outputs at batch 3 and 8, and the program of a process that
runs exported programs with the port's kernel ops alone."""

import json
import os

import numpy as np

from graphical_gan_tpu_torch.core.config import (
    asdict, gan_inference_defaults, gmgan_defaults, ssgan_defaults)
from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
from graphical_gan_tpu_torch.models.gmgan import GMGanModel
from graphical_gan_tpu_torch.models.ssgan import SSGanModel
from graphical_gan_tpu_torch.serve.export import export_sampler
from graphical_gan_tpu_torch.serve.server import (
    _draw_prior, sampler_from_run_dir)
from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "gan_inference": (GanInferenceModel, gan_inference_defaults("mnist",
                                                                "vae", dim=4,
                                                                batch_size=4)),
    "celeba": (GanInferenceModel, gan_inference_defaults(
        "celeba", "ali", dim=4, dim_g=4, dim_d=4, batch_size=4)),
    "gmgan": (GMGanModel, gmgan_defaults("mnist", "local_ep", dim=4,
                                         batch_size=4, n_coms=3)),
    "ssgan": (SSGanModel, ssgan_defaults("moving_mnist", "local_ep", dim=4,
                                         dim_op=16, batch_size=4,
                                         seq_len=2)),
}
BATCHES = (3, 8)
SEED = 5


def _inputs(kinds, shapes, n, seed):
    """Prior draws for latent inputs; raw-space data for image inputs."""
    rng = np.random.default_rng(seed)
    out = []
    for kind, shape in zip(kinds, shapes):
        if kind == "image":
            out.append((rng.random((n,) + tuple(shape[1:])) * 255)
                       .astype(np.float32))
        else:
            out.append(_draw_prior([kind], [shape], n, rng.integers(1 << 30))
                       [0])
    return out


def export_cases(base, cases):
    """{case: (manifest, {batch: (inputs, run-dir output)})}: each (run,
    entry, quantize) case exported under ``base`` (the runs written there
    first), with the run directory's outputs at BATCHES for SEED."""
    out = {}
    for run in {case[0] for case in cases}:
        cls, cfg = RUNS[run]
        path = str(base / run)
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(asdict(cfg), f)
        ckpt_lib.save_params(os.path.join(path, "ckpt_4.npz"),
                             cls(cfg).init(seed=1, device="cpu"),
                             {"iteration": 4})
    for case in cases:
        run, entry, quantize = case
        path = str(base / run)
        info = export_sampler(path, entry=entry, quantize=quantize,
                              calib_seed=11, device="cpu",
                              out=str(base / f"{run}-{entry}-{quantize}"))
        call, kinds, shapes, _ = sampler_from_run_dir(
            path, entry=entry, device="cpu", quantize=quantize)
        ref = {}
        for n in BATCHES:
            inputs = _inputs(kinds, shapes, n, n)
            ref[n] = (inputs, call(SEED, *inputs))
        out[case] = (info, ref)
    return out




EXPECTED_DRAWS = {("gan_inference", "encoder"): ["eps_q"],
                  ("gan_inference", "reconstructor"): ["eps_q"],
                  ("celeba", "encoder"): ["dequant"],
                  ("ssgan", "sampler"): ["epsilon"]}


def check_case(info, ref, case):
    """The manifest of ``case`` and its loaded program at each batch of
    ``ref`` against the run directory's outputs, bit for bit."""
    from graphical_gan_tpu_torch.serve.export import load_sampler
    run, entry, quantize = case
    assert info["symbolic_batch"] is True
    assert info["entry"] == entry and info["device"] == "cpu"
    assert info["quantization"] == (quantize or "none")
    assert info["iteration"] == 4 and info["checkpoint"] == "ckpt_4.npz"
    assert os.path.exists(os.path.join(os.path.dirname(info["blob"]),
                                       "act_scales.json")) == bool(quantize)
    assert [d["name"] for d in info["draws"]] == \
        EXPECTED_DRAWS.get((run, entry), [])
    call = load_sampler(info["blob"])
    for n in BATCHES:
        inputs, want = ref[n]
        got = call(SEED, *inputs).float().numpy()
        assert got.shape == want.shape and got.shape[0] == n
        np.testing.assert_array_equal(got, want)
    if info["draws"]:  # another seed, other draws
        inputs, want = ref[BATCHES[0]]
        assert not np.array_equal(call(SEED + 1, *inputs).numpy(), want)


_BARE = """
import json, os, sys
import numpy as np
import torch
import graphical_gan_tpu_torch.ops.kernels  # registers the ggan ops
cases = json.load(open(sys.argv[1]))
for c in cases:
    man = json.load(open(os.path.join(c["dir"], "manifest.json")))
    for name, value in man["numerics"].items():
        obj = torch.backends
        *path, attr = name.split(".")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, attr, value)
    program = torch.export.load(os.path.join(c["dir"], man["blob"])).module()
    data = np.load(c["data"])
    for n in c["batches"]:
        inputs = [torch.from_numpy(data[f"{n}_in{i}"])
                  for i in range(len(man["inputs"]))]
        gen = torch.Generator()
        gen.manual_seed(c["seed"])
        draws = []
        for d in man["draws"]:
            shape = (n,) + tuple(d["shape"][1:])
            if d["kind"] == "normal":
                draws.append(torch.randn(shape, generator=gen,
                                         dtype=getattr(torch, d["dtype"])))
            else:
                draws.append(torch.rand(shape, generator=gen))
        with torch.no_grad():
            got = program(*inputs, *draws).float().numpy()
        assert np.array_equal(got, data[f"{n}_out"]), (c["dir"], n)
loaded = sorted(m for m in sys.modules if m.startswith("graphical_gan"))
bad = [m for m in loaded if m.split(".")[1:2] in (
    ["models"], ["serve"], ["train"], ["runs"], ["tools"], ["data"],
    ["objectives"], ["core"])]
assert not bad, bad
print("ok", len(cases))
"""


