"""Serving-side throughput and latency (``graphical_gan_tpu/tools/
bench_serving.py``).

It measures a family's serving entry (``serve/export.py: make_entry``, the
function the server calls; ``--entry`` picks the generator sampler or the
inference side: encoder, cluster, reconstructor) on the card across
request batch sizes, with random weights from a seed or a run directory's.

Method: one warm call per batch outside the clock, then per round
``--depth`` dispatches bounded by ONE ``torch.cuda.synchronize``, so the
per-request latency is the pipelined amortized figure (``--depth 1``: one
request's round trip); best of ``--rounds``; one JSON line per (family,
batch). The default batches include 8 and 256, the serving metrics of
PERF.md §2 (latency at bucket 8, rows/s at bucket 256).

    python -m graphical_gan_tpu_torch.tools.bench_serving \\
        [--families gan_inference,gmgan,ssgan] [--batches 8,64,256]
        [--entry sampler] [--depth 10] [--rounds 5] [--dtype bfloat16]
        [--run-dir DIR] [--quantize int8] [--via-export] [--device cpu]

``--quantize int8`` measures the sampler on the int8 path (``ops/quant.py``:
the Q1/Q2 kernels), its scales calibrated on 2 batches of prior latents
from seed 11, as JAX's tool does (``tools/bench_serving.py:88-105``).
``--via-export`` measures the entry as ``serve/export.py`` exports it,
through a save and load of the ``torch.export`` program.

Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from graphical_gan_tpu_torch.tools.mfu import device_kind


def build(family: str, dtype: str = "bfloat16", **overrides):
    """The family's model at the published config JAX's bench serves:
    cifar10 wali-gp, gmgan cifar10 local_ep, ssgan moving-MNIST local_ep."""
    from graphical_gan_tpu_torch.tools.mfu import family_model
    return family_model({"gan_inference": "gan"}.get(family, family), dtype,
                        **overrides)[1]


def _inputs(example, kinds, n: int, gen: torch.Generator, device):
    """Random request inputs of ``n`` rows: raw-space pixels for an image
    (values do not change the time), one-hot rows for a component, N(0, 1)
    otherwise."""
    out = []
    for a, kind in zip(example, kinds):
        shape = (n,) + tuple(a.shape[1:])
        if kind == "image":
            out.append(torch.rand(shape, generator=gen, device=device) * 255)
        elif kind == "onehot":
            k = int(shape[1])
            idx = torch.randint(0, k, (n,), generator=gen, device=device)
            out.append(torch.eye(k, device=device)[idx])
        else:
            out.append(torch.randn(shape, generator=gen, device=device))
    return tuple(out)


def _exported(family, model, params, entry, scales, dev):
    """The entry as ``serve/export.py`` exports it, saved and loaded back
    (the whole round trip), called as ``fn(params, seed, *inputs)``: its
    draws from a generator seeded ``seed``, as ``load_sampler`` draws
    them."""
    import os
    import tempfile
    from graphical_gan_tpu_torch.serve.export import export_entry, replay_draw
    program, draws, _ = export_entry(family, model, params, entry, scales)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{entry}.pt2")
        torch.export.save(program, path)
        loaded = torch.export.load(path).module()

    def fn(params, seed, *inputs):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return loaded(*inputs, *[replay_draw(d, inputs[0].shape[0], gen, dev)
                                 for d in draws])
    return fn


def measure(family: str, batches, depth: int = 10, rounds: int = 5,
            entry: str = "sampler", dtype: str = "bfloat16", device="cuda",
            run_dir=None, quantize=None, via_export: bool = False,
            **overrides):
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    from graphical_gan_tpu_torch.serve.export import make_entry
    dev = resolve_device(device)
    set_numerics()
    model = build(family, dtype, **overrides)
    if run_dir:
        from graphical_gan_tpu_torch.tools.generate import restore_params
        from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
        params, _ = restore_params(model, ckpt_lib.latest(run_dir), dev)
    else:
        params = model.init(0, dev)
    fn, example, kinds = make_entry(family, model, entry)
    scales = None
    if quantize == "int8":
        if entry != "sampler":
            raise ValueError("--quantize int8 applies to the sampler entry "
                             "only (calibration is prior-latent-based)")
        from graphical_gan_tpu_torch.serve.quantize import calibrate
        scales = calibrate(family, model, params, 11, n_batches=2)
    elif quantize not in (None, "none"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if via_export:
        fn = _exported(family, model, params, entry, scales, dev)
    elif scales is not None:
        from graphical_gan_tpu_torch.serve.quantize import quantized_entry
        fn = quantized_entry(fn, scales)
    cuda = dev.type == "cuda"
    frames = getattr(model.cfg, "seq_len", 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    results = []
    with torch.inference_mode():
        for n in batches:
            inp = _inputs(example, kinds, n, gen, dev)
            fn(params, 1, *inp)  # warm: kernel builds, cuDNN plans
            best = float("inf")
            for r in range(rounds):
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for i in range(depth):
                    fn(params, r * depth + i, *inp)
                if cuda:
                    torch.cuda.synchronize(dev)
                best = min(best, (time.perf_counter() - t0) / depth)
            name = (f"{family}_serving_throughput" if entry == "sampler"
                    else f"{family}_{entry}_serving_throughput")
            results.append({
                "metric": name, "entry": entry, "dtype": dtype,
                "quantize": quantize or "none",
                "path": "export" if via_export else "eager",
                "batch": n, "latency_ms": best * 1e3,
                "samples_per_sec": n / best,
                **({"frames_per_sec": n * frames / best}
                   if frames > 1 else {}),
                "device_kind": device_kind(dev), "pipeline_depth": depth})
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--families", default="gan_inference,gmgan,ssgan")
    p.add_argument("--batches", default="8,64,256")
    p.add_argument("--depth", type=int, default=10,
                   help="dispatches per synchronize (1 = one request's "
                        "round trip)")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--entry", default="sampler",
                   choices=["sampler", "encoder", "cluster", "reconstructor"],
                   help="which serving entry to measure (per family: "
                        "serve/export.ENTRIES)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--run-dir", default=None,
                   help="load trained params from a run dir (default: "
                        "random weights from seed 0, the same compute)")
    p.add_argument("--dim", type=int, default=None,
                   help="override the model width (smoke/testing)")
    p.add_argument("--quantize", default=None, choices=["none", "int8"],
                   help="measure the int8 PTQ sampler (ops/quant.py)")
    p.add_argument("--via-export", action="store_true",
                   help="measure the entry as serve/export.py exports it "
                        "(saved and loaded back)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    overrides = {} if args.dim is None else {"dim": args.dim}
    batches = [int(b) for b in args.batches.split(",")]
    for family in args.families.split(","):
        for rec in measure(family, batches, args.depth, args.rounds,
                           args.entry, args.dtype, args.device,
                           args.run_dir, args.quantize, args.via_export,
                           **overrides):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
