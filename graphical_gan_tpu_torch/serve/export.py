"""Serving entries (``graphical_gan_tpu/serve/export.py:53-146``).

Each entry is ``fn(params, seed, *inputs) -> output`` over tensors, with
``example`` inputs (numpy zeros at the config's batch size) that give the
input shapes. ``seed`` is the request's seed: the image entries draw what the model
draws (celeba's dequantization noise, a learn/fix_std posterior's eps) from
a ``torch.Generator`` seeded with it, on the inputs' device, so an exact
request is reproducible, as the JAX package's ``call(key, *inputs)`` is.

Per family the sampler is ``fn(params, seed, *inputs) -> images``:

- gan_inference: ``noise [n, dim_latent]``;
- gmgan: ``k_onehot [n, n_coms], noise [n, dim_latent]``;
- ssgan: ``z_l_0 [n, dim_latent_l], z_g [n, dim_latent_g]`` and, for a
  conditional model, one-hot ``labels [n, n_classes]``; the motion chain's
  eps is drawn from the seed. Output: videos [n, LEN, C·H·W].

ssgan's ``reconstructor`` takes raw videos [n, LEN, C·H·W] (and the
one-hot labels of a conditional model). In place of an int seed an entry
also takes its draws by name (a dict), which is how an exported program
runs it.

Artifact export (``graphical_gan_tpu/serve/export.py:163-310``):
:func:`export_sampler` writes a run directory's entry as a
``torch.export`` program, ``<entry>.pt2``, with the run's parameters in it
(and for ``--quantize int8`` its int8 weights and activation scales), the
batch dimension symbolic where ``torch.export`` takes it (else the
example batch, the manifest's ``fixed_batch_reason`` saying why), beside
``manifest.json`` (JAX's fields; ``device`` in place of ``platforms``: the program runs on
the device it was exported on) and, for int8, ``act_scales.json``. The
draws an entry makes from its seed (SSGAN's chain eps, celeba's
dequantization noise, a learned-σ posterior's eps) stay outside the
program: :func:`load_sampler` returns ``call(seed, *inputs)``, which draws
them from a ``torch.Generator`` seeded as the entry seeds it and hands them
to the program, so an exported call equals the run-directory call bit for
bit on the same device. Loading needs ``torch`` and the port's kernel ops
(``import graphical_gan_tpu_torch.ops.kernels``, which registers the
``ggan::`` ops the program calls), not the model code.

    python -m graphical_gan_tpu_torch.serve.export --run-dir R \
        [--entry sampler] [--quantize int8] [--fixed-batch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: deployable entries per family ported so far
ENTRIES = {
    "gan_inference": ("sampler", "encoder", "reconstructor"),
    "gmgan": ("sampler", "encoder", "cluster", "reconstructor"),
    "ssgan": ("sampler", "reconstructor"),
}

#: what the entry's single output array is
ENTRY_OUTPUT = {"sampler": "images", "reconstructor": "images",
                "encoder": "latents", "cluster": "probs"}


def _generator(seed: int, like: torch.Tensor) -> torch.Generator:
    gen = torch.Generator(device=like.device)
    gen.manual_seed(int(seed))
    return gen


def _draw_source(seed, like: torch.Tensor) -> dict:
    """The keywords that give an entry its random numbers: a generator on
    ``like``'s device seeded with the int ``seed``, or, where ``seed`` is a
    dict, the draws themselves by name (what an exported program is
    handed)."""
    if isinstance(seed, dict):
        return {"draws": seed}
    return {"generator": _generator(seed, like)}


def make_sampler(family: str, model) -> Tuple:
    """(fn, example_inputs) for the generator-side entry."""
    cfg = model.cfg
    n = cfg.batch_size
    if family == "gan_inference":
        def fn(params, seed, noise):
            return model.sample(params, noise)
        example = (np.zeros((n, cfg.dim_latent), np.float32),)
    elif family == "gmgan":
        def fn(params, seed, k_onehot, noise):
            return model.sample(params, k_onehot, noise)
        example = (np.zeros((n, cfg.n_coms), np.float32),
                   np.zeros((n, cfg.dim_latent), np.float32))
    elif family == "ssgan":
        def fn(params, seed, z_l_0, z_g, *labels):
            return model.sample(params, z_l_0, z_g,
                                labels[0] if labels else None,
                                **_draw_source(seed, z_l_0))
        example = (np.zeros((n, cfg.dim_latent_l), np.float32),
                   np.zeros((n, cfg.dim_latent_g), np.float32))
        if cfg.conditional:
            example += (np.zeros((n, cfg.n_classes), np.float32),)
    else:
        raise ValueError(f"unknown family {family!r}")
    return fn, example


def make_entry(family: str, model, entry: str = "sampler") -> Tuple:
    """(fn, example_inputs, input_kinds) for a family's serving entry.

    The image entries take RAW-space data as the dataset loaders yield it
    (``model.normalize`` runs inside): ``encoder`` x -> q_z,
    ``reconstructor`` x -> G(E(x)) and, for gmgan, ``cluster`` x -> q(k|x)
    (``gmgan_inference_mnist.py:513-531``). ``input_kinds`` are
    ``"normal"`` / ``"onehot"`` (the server can draw them from a seed) or
    ``"image"`` (the client sends it).
    """
    if entry not in ENTRIES.get(family, ()):
        raise ValueError(f"family {family!r} has no entry {entry!r}; "
                         f"choose from {ENTRIES.get(family, ())}")
    if entry == "sampler":
        from graphical_gan_tpu_torch.serve.server import input_kinds
        fn, example = make_sampler(family, model)
        return fn, example, input_kinds(family, model.cfg)

    cfg = model.cfg
    if family == "ssgan":  # the reconstructor (ENTRIES gates the rest)
        def fn(params, seed, raw_x, *labels):
            return model.reconstruct(params, raw_x,
                                     labels[0] if labels else None)
        example = (np.zeros((cfg.batch_size, cfg.seq_len, cfg.output_dim),
                            np.float32),)
        if not cfg.conditional:
            return fn, example, ["image"]
        return (fn, example + (np.zeros((cfg.batch_size, cfg.n_classes),
                                        np.float32),), ["image", "onehot"])

    method = {"encoder": model.encode, "reconstructor": model.reconstruct,
              "cluster": getattr(model, "cluster_probs", None)}[entry]

    def fn(params, seed, raw_x):
        return method(params, raw_x, **_draw_source(seed, raw_x))
    example = (np.zeros((cfg.batch_size, cfg.data.output_dim), np.float32),)
    return fn, example, ["image"]


# ---------------------------------------------------------------------------
# artifact export

MAX_BATCH = 65536  # the largest batch the symbolic dimension admits


class _Program(torch.nn.Module):
    """What is exported: the run's parameters as buffers and an entry's
    function, called with its inputs and then its draws by name, under the
    int8 context where the export is quantized (its weight cache filled
    before tracing, so the program holds the int8 weights as constants)."""

    def __init__(self, fn, params, n_inputs: int, draws: List[dict],
                 scales: Optional[Dict[str, float]], weights: dict):
        super().__init__()
        self.fn, self.n_inputs, self.draws = fn, n_inputs, draws
        self.names = list(params)
        for i, name in enumerate(self.names):
            self.register_buffer(f"param{i}", params[name])
        self.scales, self.weights = scales, weights

    def forward(self, *args):
        from graphical_gan_tpu_torch.ops import quant
        params = {name: getattr(self, f"param{i}")
                  for i, name in enumerate(self.names)}
        drawn = {d["name"]: t for d, t in zip(self.draws,
                                              args[self.n_inputs:])}
        ctx = (quant.quantized(self.scales, self.weights)
               if self.scales is not None else nullcontext())
        with ctx:
            return self.fn(params, drawn, *args[:self.n_inputs])


def replay_draw(spec: dict, n: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """One draw of ``spec`` (a :func:`models.common.recording_draws` entry)
    for batch ``n``: the call the entry's :class:`Draws` makes."""
    shape = (n,) + tuple(spec["shape"][1:])
    if spec["kind"] == "normal":
        return torch.randn(shape, generator=gen, device=device,
                           dtype=getattr(torch, spec["dtype"]))
    if spec["kind"] == "uniform":
        return torch.rand(shape, generator=gen, device=device)
    return torch.randint(0, spec["high"], shape, generator=gen,
                         device=device)


def export_entry(family: str, model, params: Dict[str, torch.Tensor],
                 entry: str = "sampler",
                 scales: Optional[Dict[str, float]] = None,
                 symbolic_batch: bool = True):
    """(``torch.export`` program, its draws, why its batch is fixed: None
    where it is symbolic) of ``make_entry``'s function over ``params`` (on
    their device); with ``scales`` the int8 path. The entry runs once
    eagerly first: that records its draws and fills the int8 weight cache.
    Only ``torch.export``'s refusal of the symbolic batch (a dimension
    specialized, or a guard on it) falls back to the example batch, with
    a warning; any other error of the export is raised."""
    from graphical_gan_tpu_torch.models.common import recording_draws
    from graphical_gan_tpu_torch.ops import quant
    fn, example, _ = make_entry(family, model, entry)
    dev = next(iter(params.values())).device
    inputs = [torch.from_numpy(a).to(dev) for a in example]
    n = inputs[0].shape[0]
    weights: dict = {}
    draws: List[dict] = []
    with torch.no_grad(), recording_draws(draws), (
            quant.quantized(scales, weights) if scales is not None
            else nullcontext()):
        fn(params, 0, *inputs)
    if any(d["shape"][0] != n for d in draws):
        raise ValueError(f"{family} {entry}: a draw's first dimension is "
                         f"not the batch: {draws}")
    gen = torch.Generator(device=dev)
    args = tuple(inputs) + tuple(replay_draw(d, n, gen, dev) for d in draws)
    program = _Program(fn, params, len(inputs), draws, scales, weights)
    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    fixed_why = "a fixed batch was asked for"
    with torch.no_grad():
        if symbolic_batch:
            try:
                # forward(*args): one spec per argument, in the tuple of
                # the varargs
                return (torch.export.export(
                    program, args,
                    dynamic_shapes=(tuple({0: batch} for _ in args),)),
                    draws, None)
            except _symbolic_refusals() as e:
                lines = [ln.strip() for ln in str(e).splitlines()
                         if ln.strip()]
                fixed_why = f"{type(e).__name__}: {' '.join(lines[:3])}"
                warnings.warn(f"{family} {entry}: exported at the fixed "
                              f"batch {n}: {fixed_why}")
        return torch.export.export(program, args), draws, fixed_why


def _symbolic_refusals():
    """The errors by which ``torch.export`` refuses a symbolic dimension."""
    from torch._dynamo.exc import UserError
    from torch.fx.experimental.symbolic_shapes import (
        ConstraintViolationError, GuardOnDataDependentSymNode)
    return UserError, ConstraintViolationError, GuardOnDataDependentSymNode


def export_sampler(run_dir: str, ckpt: Optional[str] = None,
                   out: Optional[str] = None, symbolic_batch: bool = True,
                   quantize: Optional[str] = None, calib_batches: int = 4,
                   calib_seed: int = 0, entry: str = "sampler",
                   device="cuda") -> dict:
    """Export a run directory's serving entry to ``<entry>.pt2`` beside
    ``manifest.json`` (and ``act_scales.json`` for int8), in
    ``<run_dir>/export/`` (the sampler) or ``<run_dir>/export_<entry>/``;
    returns the manifest with the files' full paths.

    ``quantize="int8"`` calibrates the activation scales on prior latents
    (``serve/quantize.py``, ``calib_batches`` from ``calib_seed``) and
    exports the int8 path; sampler entry only."""
    from graphical_gan_tpu_torch.core.device import (
        NUMERICS, resolve_device, set_numerics)
    from graphical_gan_tpu_torch.ops import quant
    from graphical_gan_tpu_torch.tools.generate import rebuild, restore_params
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

    dev = resolve_device(device)
    set_numerics()
    family, cfg, model = rebuild(run_dir)
    path = ckpt or ckpt_lib.latest(run_dir)
    if path is None:
        raise FileNotFoundError(f"no ckpt_*.npz under {run_dir}")
    params, extra = restore_params(model, path, dev)
    _, example, kinds = make_entry(family, model, entry)
    scales = None
    if quantize == "int8":
        if entry != "sampler":
            raise ValueError("--quantize int8 calibrates on prior latents "
                             "and applies to the sampler entry only")
        from graphical_gan_tpu_torch.serve.quantize import calibrate
        scales = calibrate(family, model, params, calib_seed,
                           n_batches=calib_batches)
    elif quantize not in (None, "none"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    program, draws, fixed_why = export_entry(family, model, params, entry,
                                             scales, symbolic_batch)

    outf = out or os.path.join(
        run_dir, "export" if entry == "sampler" else f"export_{entry}")
    os.makedirs(outf, exist_ok=True)
    blob = os.path.join(outf, f"{entry}.pt2")
    torch.export.save(program, blob)
    if scales is not None:  # provenance of the quantized program
        quant.save_scales(os.path.join(outf, "act_scales.json"), scales)
    display = {"unit": "x", "unit_pm1": "(x+1)/2", "int_pm1": "(x+1)/2",
               "dequant": "(x+1)/2", "int256_pm1": "(x+1)/2"}
    manifest = {
        "family": family, "entry": entry, "blob": os.path.basename(blob),
        "output": ENTRY_OUTPUT[entry],
        "iteration": int(extra.get("iteration", -1)),
        "checkpoint": os.path.basename(path),
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "symbolic_batch": fixed_why is None,
        **({} if fixed_why is None else {"fixed_batch_reason": fixed_why}),
        "quantization": quantize or "none",
        "inputs": [{"shape": list(a.shape), "dtype": str(a.dtype),
                    "prior": kind} for a, kind in zip(example, kinds)],
        "draws": draws,
        "key": "an int seed: a torch.Generator on the program's device, "
               "seeded with it, draws the program's 'draws' in order",
        # the process-wide numerics the program gives the run's bits under
        "numerics": NUMERICS,
        "output_to_display": display.get(cfg.data.normalization
                                         if hasattr(cfg, "data") else
                                         "unit_pm1", "x"),
    }
    man_path = os.path.join(outf, "manifest.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return {**manifest, "blob": blob, "manifest": man_path}


def load_sampler(blob_path: str):
    """An exported entry as ``call(seed, *inputs) -> tensor``: the inputs
    (arrays or tensors, f32) go to the program's device, its draws come
    from a generator there seeded with ``seed``. Needs the manifest beside
    the program and the port's kernel ops, nothing of the model code."""
    import graphical_gan_tpu_torch.ops.kernels  # noqa: F401 — the ggan ops
    from graphical_gan_tpu_torch.core.device import apply_numerics
    with open(os.path.join(os.path.dirname(blob_path),
                           "manifest.json")) as f:
        manifest = json.load(f)
    apply_numerics(manifest["numerics"])
    program = torch.export.load(blob_path).module()
    dev = torch.device(manifest["device"])
    draws = manifest["draws"]

    def call(seed: int, *inputs) -> torch.Tensor:
        ts = [torch.as_tensor(np.asarray(a, np.float32)).to(dev)
              for a in inputs]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        drawn = [replay_draw(d, ts[0].shape[0], gen, dev) for d in draws]
        with torch.no_grad():
            return program(*ts, *drawn)
    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Export a run directory's "
                                "serving entry as a torch.export program")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--fixed-batch", action="store_true",
                   help="export at the config batch size instead of a "
                        "symbolic batch dimension")
    p.add_argument("--quantize", default=None, choices=["none", "int8"],
                   help="export the int8 PTQ path (activation scales "
                        "calibrated on prior latents; serve/quantize.py)")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="calibration batches for --quantize int8")
    p.add_argument("--entry", default="sampler",
                   choices=["sampler", "encoder", "cluster", "reconstructor"],
                   help="which serving entry to export (ENTRIES per family)")
    p.add_argument("--device", default="cuda",
                   help="the device the program runs on: cuda (default) or "
                        "cpu")
    args = p.parse_args(argv)
    info = export_sampler(args.run_dir, ckpt=args.ckpt, out=args.out,
                          symbolic_batch=not args.fixed_batch,
                          quantize=args.quantize,
                          calib_batches=args.calib_batches,
                          entry=args.entry, device=args.device)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
