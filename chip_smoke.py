#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX or of the JAX package, and does in order:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles ``graphical_gan_tpu_torch/csrc/*.cu`` with nvcc;
3. check: holds each kernel (K1 conv+bias+act, K2a BN stats, K2b BN apply)
   against its plain PyTorch version at every serving shape, B in
   {8, 64, 256}, f32 and bf16, plus BN inputs with a large mean;
4. time: per kernel and shape, the kernel's median time from CUDA events
   on inputs that are not in L2, its plain version's, one PyTorch library
   call's, and the bound (bytes over 3.35 TB/s or the operations the
   function needs, taps in the padding left out, over 67 TFLOP/s f32 /
   989 TFLOP/s bf16);
5. serve: writes a full-width cifar10 wali-gp run directory (random
   weights from a seed), serves the sampler, encoder and reconstructor
   entries over HTTP on localhost through the port's server, checks the
   outputs and that every dispatch went through the kernels, and compares a
   64-row reconstruction with the same model on the CPU;
6. dispatch: per dtype, entry and bucket, a dispatch's host and device
   time, its device busy share and its device time by kernel group;
7. prints one JSON line per kernel summary, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. ``--log PATH`` also
writes every logged line to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32 = 67e12     # H100 SXM f32 outside the tensor cores (no TF32)
PEAK_BF16 = 989e12   # H100 SXM bf16 tensor cores, dense
HBM_BYTES_S = 3.35e12
BUCKETS = (8, 64, 256)

# (tolerance atol, rtol) for kernel vs plain version on the same inputs
TOL = {
    # f32: same products summed in another order (K1 depth up to 3200)
    ("conv", "float32"): (1e-4, 1e-4),
    # bf16 output: one bf16 rounding (2^-8 relative) may flip
    ("conv", "bfloat16"): (1e-2, 1e-2),
    # stats are f32 in both dtypes; Welford/Chan vs two-pass order
    ("stats", "float32"): (1e-5, 1e-4),
    ("stats", "bfloat16"): (1e-5, 1e-4),
    # apply: one fused multiply-add vs two roundings; bf16 output rounding
    ("apply", "float32"): (1e-5, 1e-5),
    ("apply", "bfloat16"): (1e-2, 1e-2),
}
# each half of the model on the card vs on the CPU (plain versions), f32,
# one 64-row dispatch at full width: the encoder's codes, and the
# generator's images from the same codes
STAGE_ATOL = 1e-4
# the whole reconstructor: the generator's gain at these random weights
# carries the encoder's last-bit differences up about 20-fold (each half
# within 6e-6 of the CPU, the whole between 1.2e-5 and 8.7e-5 of it on two
# H100 machines, whose host CPUs differ), so the bound is set above that
# spread
E2E_ATOL = 5e-4


class SmokeFailure(Exception):
    pass


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


_LINES = []  # every logged line, for --log


def log(obj) -> None:
    line = json.dumps(obj) if not isinstance(obj, str) else obj
    _LINES.append(line)
    print(line, flush=True)


# ---------------------------------------------------------------------------
# shapes of one dispatch of the reconstructor (E then G), batch b

def conv_shapes(b: int):
    # name, x shape NHWC, Cout, act  (all 5x5 stride 2 SAME)
    return [("E.1", (b, 32, 32, 3), 64, "leaky_relu"),
            ("E.2", (b, 16, 16, 64), 128, None),
            ("E.3", (b, 8, 8, 128), 256, None)]


def bn_shapes(b: int):
    # name, (R, C), act
    return [("E.BN2", (64 * b, 128), "leaky_relu"),
            ("E.BN3", (16 * b, 256), "leaky_relu"),
            ("G.BN1", (b, 4096), "relu"),
            ("G.BN2", (64 * b, 128), "relu"),
            ("G.BN3", (256 * b, 64), "relu")]


# ---------------------------------------------------------------------------
# helpers

def max_err(got, want, atol, rtol):
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        return float("inf"), True
    return float(diff.max()), bool(bad.any())


def time_ms(fn, args, reps: int = 7, inner: int = 20) -> float:
    """Median device time of one ``fn(*args)``, from CUDA events around
    ``inner`` back-to-back calls. The calls rotate over copies of the
    tensors in ``args`` that together hold at least twice the card's L2, so
    each call reads its inputs from device memory, as the bytes bound
    assumes, and not from what the call before left in L2. A spin kernel
    queued first keeps the card busy while the host enqueues the calls, so
    host overhead is not timed."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2**20)
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, -(-2 * l2 // max(nbytes, 1)))
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]
    calls = 0

    def run(k):
        nonlocal calls
        for _ in range(k):
            fn(*sets[calls % n])
            calls += 1

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(inner)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(t_host * 2.0e9 * 1.5, 1e5), 4e9))
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run(inner)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def conv_valid_taps(n: int, k: int, s: int, lo: int) -> int:
    """Taps of a k-wide window at stride s over n inputs (low pad ``lo``,
    SAME output size) that land inside the input, summed over the output
    positions of one axis; taps in the padding multiply zeros and are not
    work the function needs."""
    return sum(1 for o in range(-(-n // s)) for t in range(k)
               if 0 <= o * s - lo + t < n)


def bound(flops: float, nbytes: float, dtype: str):
    peak = PEAK_BF16 if dtype == "bfloat16" else PEAK_F32
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phases

def phase_device():
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi unavailable: {e}"]
    card = smi[0] if smi else "nvidia-smi printed nothing"
    info = {"phase": "device", "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": card}
    log(info)
    if tuple(torch.cuda.get_device_capability(0)) != (9, 0):
        fail(f"kernels are built for sm_90a; this card is "
             f"{torch.cuda.get_device_capability(0)}")
    return card


def phase_build():
    from graphical_gan_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    path = build.build(force=True)
    secs = time.perf_counter() - t0
    build.lib()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log({"phase": "build", "seconds": round(secs, 3),
         "library": os.path.relpath(path, ROOT),
         "sources": [os.path.relpath(s, ROOT) for s in build.sources()]})
    for ln in ptxas:
        log("ptxas: " + ln)


def _conv_inputs(shape, cout, dtype, gen, k=5):
    import torch
    b, h, w, cin = shape
    x = torch.randn(shape, generator=gen, device="cuda")
    std = (4.0 / (cin * k * k + cout * k * k // 4)) ** 0.5  # the he init
    wt = (torch.rand((k, k, cin, cout), generator=gen, device="cuda") * 2
          - 1) * std * 3 ** 0.5
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return x.to(dtype), wt, bias


def _bn_inputs(rc, dtype, gen, mean=0.0):
    import torch
    r, c = rc
    x = torch.randn(rc, generator=gen, device="cuda") * 2.0 + mean
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    offset = torch.randn((c,), generator=gen, device="cuda")
    return x.to(dtype), scale, offset


# shapes off the serving path that reach the kernels' edge handling: odd
# sizes, stride 1, VALID, 1x1, Cin 1, Cout not a multiple of the 64-wide
# tile; BN with C not a multiple of 4 (scalar apply) and ragged row blocks
EDGE_CONV = [("odd7", (2, 7, 7, 8), 16, 5, 2, "SAME", "relu"),
             ("s1", (2, 9, 9, 8), 8, 3, 1, "SAME", "leaky_relu"),
             ("valid", (2, 12, 12, 8), 8, 5, 2, "VALID", None),
             ("1x1", (2, 8, 8, 8), 24, 1, 1, "SAME", None),
             ("cin1", (3, 5, 5, 1), 70, 3, 1, "SAME", "leaky_relu")]
EDGE_BN = [("r196", (196, 16), "relu"), ("c5", (3, 5), "leaky_relu"),
           ("c130", (1000, 130), None), ("c4100", (7, 4100), "relu")]


def _check_conv(label, x, w, bias, stride, padding, act, errs, misses):
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    dn = str(x.dtype).split(".")[1]
    got = fused_conv.fused_conv2d_bias_act(x, w, bias, stride, padding, act)
    want = fused_conv.fused_conv2d_bias_act_plain(x, w, bias, stride,
                                                  padding, act)
    torch.cuda.synchronize()
    atol, rtol = TOL[("conv", dn)]
    e, bad = max_err(got, want, atol, rtol)
    errs["fused_conv2d_bias_act"] = max(
        errs.get("fused_conv2d_bias_act", 0.0), e)
    log({"check": "K1", "shape": label, "dtype": dn, "max_abs_err": e,
         "atol": atol, "rtol": rtol, "ok": not bad})
    if bad or got.dtype != x.dtype or got.shape != want.shape:
        misses.append(f"K1 {label} {dn}")


def _check_bn(label, x, scale, offset, act, mean, errs, misses):
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    dn = str(x.dtype).split(".")[1]
    m, v, inv = fused_norm.bn_stats(x)
    pm, pv, pinv = fused_norm.bn_stats_plain(x)
    y = fused_norm.bn_apply(x, pm, pinv, scale, offset, act)
    py = fused_norm.bn_apply_plain(x, pm, pinv, scale, offset, act)
    torch.cuda.synchronize()
    atol, rtol = TOL[("stats", dn)]
    es = []
    bad_s = False
    for got, want in ((m, pm), (v, pv), (inv, pinv)):
        e, bad = max_err(got, want, atol * (1 + mean), rtol)
        es.append(e)
        bad_s |= bad
    # the merged (mean, M2) form against an f64 reference (a bf16 column
    # can hold one repeated value: var 0 exactly)
    v64 = x.double().var(dim=0, unbiased=False)
    floor = v64.clamp_min(1e-30)
    rel_var = float(((v.double() - v64).abs() / floor).max())
    rel_var_plain = float(((pv.double() - v64).abs() / floor).max())
    bad_s |= rel_var > rtol
    atol_a, rtol_a = TOL[("apply", dn)]
    ea, bad_a = max_err(y, py, atol_a, rtol_a)
    errs["bn_stats"] = max(errs.get("bn_stats", 0.0), *es)
    errs["bn_apply"] = max(errs.get("bn_apply", 0.0), ea)
    log({"check": "K2", "shape": label, "dtype": dn, "R": x.shape[0],
         "C": x.shape[1],
         "stats_max_abs_err": {"mean": es[0], "var": es[1], "inv": es[2]},
         "var_rel_err_vs_f64": rel_var,
         "plain_var_rel_err_vs_f64": rel_var_plain,
         "apply_max_abs_err": ea, "ok": not (bad_s or bad_a)})
    if bad_s:
        misses.append(f"K2a {label} {dn}")
    if bad_a or y.dtype != x.dtype:
        misses.append(f"K2b {label} {dn}")


def phase_check(errs):
    """Each kernel against its plain version on the same inputs; ``errs``
    collects the max |Δ| per kernel."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    misses = []
    for dtype in (torch.float32, torch.bfloat16):
        for b in BUCKETS:
            for name, shape, cout, act in conv_shapes(b):
                x, w, bias = _conv_inputs(shape, cout, dtype, gen)
                _check_conv(f"{name} B={b}", x, w, bias, 2, "SAME", act,
                            errs, misses)
            for name, rc, act in bn_shapes(b):
                for mean in (0.0, 1e3):
                    x, scale, offset = _bn_inputs(rc, dtype, gen, mean)
                    label = f"{name}{'+1e3' if mean else ''} B={b}"
                    _check_bn(label, x, scale, offset, act, mean, errs,
                              misses)
        for name, shape, cout, k, s, pad, act in EDGE_CONV:
            x, w, bias = _conv_inputs(shape, cout, dtype, gen, k)
            _check_conv(name, x, w, bias, s, pad, act, errs, misses)
        for name, rc, act in EDGE_BN:
            x, scale, offset = _bn_inputs(rc, dtype, gen)
            _check_bn(name, x, scale, offset, act, 0.0, errs, misses)
    if misses:
        fail("kernels disagree with their plain versions: "
             + ", ".join(misses))


def phase_time(timings):
    """Per kernel, shape, dtype at B in {64, 256}: kernel, plain and
    library times. ``timings`` collects the rows."""
    import torch
    import torch.nn.functional as F
    from graphical_gan_tpu_torch.ops.activations import activation
    from graphical_gan_tpu_torch.ops.kernels import fused_conv, fused_norm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    card = torch.cuda.get_device_name(0)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        size = dtype.itemsize
        for b in (64, 256):
            for name, shape, cout, act in conv_shapes(b):
                x, w, bias = _conv_inputs(shape, cout, dtype, gen)
                bb, h, wd, cin = shape
                oh, ow = h // 2, wd // 2
                lo, hi = fused_conv.same_pads(h, 5, 2)
                xpad = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi)
                             ).contiguous(memory_format=torch.channels_last)
                wlib = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                blib = bias.to(dtype)
                act_fn = activation(act)
                taps = (conv_valid_taps(h, 5, 2, lo)
                        * conv_valid_taps(wd, 5, 2, lo))
                flops = 2.0 * bb * cout * cin * taps
                nbytes = (x.numel() + bb * oh * ow * cout + w.numel()
                          + cout) * size
                t_b, by = bound(flops, nbytes, dn)
                row = {"kernel": "fused_conv2d_bias_act", "shape": name,
                       "B": b, "dtype": dn, "card": card,
                       "ms": time_ms(
                           lambda *a: fused_conv.fused_conv2d_bias_act(
                               *a, 2, "SAME", act), (x, w, bias)),
                       "plain_ms": time_ms(
                           lambda *a: fused_conv.fused_conv2d_bias_act_plain(
                               *a, 2, "SAME", act), (x, w, bias)),
                       "library_ms": time_ms(
                           lambda *a: act_fn(F.conv2d(*a, stride=2)),
                           (xpad, wlib, blib)),
                       "bound_ms": t_b, "bound_by": by,
                       "flops": flops, "bytes": nbytes}
                timings.append(row)
                log({"timing": row})
            seen = set()
            for name, rc, act in bn_shapes(b):
                x, scale, offset = _bn_inputs(rc, dtype, gen)
                r, c = rc
                mean, var, inv = fused_norm.bn_stats_plain(x)
                act_fn = activation(act)
                if rc not in seen:  # E.BN2 and G.BN2 share a shape
                    seen.add(rc)
                    t_b, by = bound(3.0 * r * c, r * c * size + 3 * c * 4,
                                    "float32")
                    row = {"kernel": "bn_stats", "shape": name, "B": b,
                           "dtype": dn, "card": card,
                           "ms": time_ms(fused_norm.bn_stats, (x,)),
                           "plain_ms": time_ms(fused_norm.bn_stats_plain,
                                               (x,)),
                           "library_ms": time_ms(
                               lambda a: torch.var_mean(a, dim=0,
                                                        correction=0), (x,)),
                           "bound_ms": t_b, "bound_by": by,
                           "library_stats_and_apply_ms": time_ms(
                               lambda *a: act_fn(F.batch_norm(
                                   a[0], None, None, *a[1:], training=True,
                                   eps=1e-5)),
                               (x, scale.to(dtype), offset.to(dtype)))}
                    timings.append(row)
                    log({"timing": row})
                t_b, by = bound(4.0 * r * c, 2 * r * c * size + 4 * c * 4,
                                "float32")
                row = {"kernel": "bn_apply", "shape": name, "B": b,
                       "dtype": dn, "card": card,
                       "ms": time_ms(
                           lambda *a: fused_norm.bn_apply(*a, act),
                           (x, mean, inv, scale, offset)),
                       "plain_ms": time_ms(
                           lambda *a: fused_norm.bn_apply_plain(*a, act),
                           (x, mean, inv, scale, offset)),
                       "library_ms": time_ms(
                           lambda *a: act_fn(F.batch_norm(
                               *a, training=False, eps=1e-5)),
                           (x, mean.to(dtype), var.to(dtype),
                            scale.to(dtype), offset.to(dtype))),
                       "bound_ms": t_b, "bound_by": by}
                timings.append(row)
                log({"timing": row})


def _post_concurrent(cl, payloads):
    results, errors = {}, []

    def work(i, kw):
        try:
            results[i] = cl.sample(**kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=work, args=(i, kw))
               for i, kw in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or len(results) != len(payloads):
        fail("concurrent requests failed: " + "; ".join(errors))
    return [results[i] for i in range(len(payloads))]


# launches of each kernel wrapper in one dispatch of each entry
PER_DISPATCH = {
    "sampler": {"fused_conv2d_bias_act": 0, "bn_stats": 3, "bn_apply": 3},
    "encoder": {"fused_conv2d_bias_act": 3, "bn_stats": 2, "bn_apply": 2},
    "reconstructor": {"fused_conv2d_bias_act": 3, "bn_stats": 5,
                      "bn_apply": 5},
}


def _drive_entry(run_dir, entry, raw, dims, device="cuda"):
    """Serve one entry over HTTP, drive it and check what comes back;
    returns the outputs by request name."""
    import numpy as np
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import serve_run_dir

    before = kernels.launches()
    httpd, batcher, identity, warmup_s = serve_run_dir(
        run_dir, entry=entry, device=device, buckets=BUCKETS, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    outs = {}
    try:
        cl = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        if not cl.healthz()["ok"]:
            fail(f"{entry}: /healthz not ok")
        latent = entry == "sampler"
        t0 = time.perf_counter()
        for n in (1, 8, 64, 100):
            if latent:
                outs[f"n{n}"] = cl.sample(n=n, seed=n)
            else:
                outs[f"n{n}"] = cl.sample(inputs=[raw[:n]])
        burst = ([dict(n=n, seed=100 + n) for n in (1, 8, 64, 100)] if latent
                 else [dict(inputs=[raw[:n]]) for n in (1, 8, 64, 100)])
        for i, o in enumerate(_post_concurrent(cl, burst)):
            outs[f"burst{i}"] = o
        outs["n300"] = (cl.sample(n=300, seed=7) if latent
                        else cl.sample(inputs=[raw[:300]]))
        if latent:
            e1 = cl.sample(n=64, seed=9, exact=True)
            e2 = cl.sample(n=64, seed=9, exact=True)
        else:
            e1 = cl.sample(inputs=[raw[:64]], seed=9, exact=True)
            e2 = cl.sample(inputs=[raw[:64]], seed=9, exact=True)
        secs = time.perf_counter() - t0
        if not np.array_equal(e1, e2):
            fail(f"{entry}: exact-mode responses differ for one seed")
        outs["exact64"] = e1
        stats = cl.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=30)

    want_rows = {"n1": 1, "n8": 8, "n64": 64, "n100": 100, "burst0": 1,
                 "burst1": 8, "burst2": 64, "burst3": 100, "n300": 300,
                 "exact64": 64}
    for key, rows in want_rows.items():
        o = outs[key]
        if o.shape != (rows, dims) or o.dtype != np.float32:
            fail(f"{entry} {key}: output {o.shape} {o.dtype}, want "
                 f"({rows}, {dims}) float32")
        if not np.isfinite(o).all():
            fail(f"{entry} {key}: non-finite output")
        if entry != "encoder" and np.abs(o).max() > 1.0:
            fail(f"{entry} {key}: output outside tanh's [-1, 1]")
    dispatches = len(BUCKETS) + stats["batches"] + stats["exact_requests"]
    after = kernels.launches()
    got = {k: after[k] - before[k] for k in after}
    want = {k: v * dispatches for k, v in PER_DISPATCH[entry].items()}
    log({"phase": "serve", "entry": entry, "warmup_s": round(warmup_s, 3),
         "requests_s": round(secs, 3), "dispatches": dispatches,
         "launches": got, "expected_launches": want, "stats": stats,
         "identity": identity})
    if got != want:
        fail(f"{entry}: kernel launches {got} != {want} "
             f"({dispatches} dispatches)")
    return outs


def phase_serve(launch_totals):
    """The port's main path: the HTTP server over a full-width cifar10
    wali-gp run directory. ``launch_totals`` receives the counts read right
    after the run (all counts were set to 0 right before it)."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.core.config import (
        asdict, gan_inference_defaults)
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    from graphical_gan_tpu_torch.train.checkpoint import save_params

    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build", "smoke_run")
    run_dirs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = gan_inference_defaults("cifar10", "wali-gp",
                                     compute_dtype=dtype)
        if (cfg.dim, cfg.dim_latent, cfg.bn) != (64, 128, True):
            fail(f"cifar10 wali-gp defaults changed: {cfg}")
        run_dir = os.path.join(base, dtype)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(asdict(cfg), f, default=str)
        params = GanInferenceModel(cfg).init(seed=0, device="cuda")
        save_params(os.path.join(run_dir, "ckpt_0.npz"), params,
                    {"iteration": 0})
        run_dirs[dtype] = run_dir
    raw = np.random.default_rng(0).integers(
        0, 256, size=(300, 3072)).astype(np.float32)

    kernels.reset_launches()
    outs = {}
    for entry, dims in (("sampler", 3072), ("encoder", 128),
                        ("reconstructor", 3072)):
        outs[entry] = _drive_entry(run_dirs["float32"], entry, raw, dims)
    bf16 = _drive_entry(run_dirs["bfloat16"], "reconstructor", raw, 3072)
    launch_totals.update(kernels.launches())

    # the same model on the CPU (plain versions), one 64-row dispatch per
    # entry; the generator half is fed the CPU's codes on both sides
    cpu = {e: sampler_from_run_dir(run_dirs["float32"], entry=e,
                                   device="cpu")[0]
           for e in ("encoder", "sampler", "reconstructor")}
    ref = cpu["reconstructor"](9, raw[:64])
    z_ref = cpu["encoder"](9, raw[:64])
    gpu_sampler, _, _, _ = sampler_from_run_dir(
        run_dirs["float32"], entry="sampler", device="cuda")
    e_enc = float(np.abs(outs["encoder"]["exact64"] - z_ref).max())
    e_gen = float(np.abs(gpu_sampler(9, z_ref) - cpu["sampler"](9, z_ref)
                         ).max())
    gpu = outs["reconstructor"]["exact64"]
    e2e = float(np.abs(gpu - ref).max())
    # the 64-row batched request ran alone in bucket 64: the same batch
    e2e_batched = float(np.abs(outs["reconstructor"]["n64"] - ref).max())
    d16 = np.abs(bf16["exact64"] - gpu)
    log({"phase": "serve-parity", "encoder_gpu_vs_cpu_max_abs_err": e_enc,
         "sampler_gpu_vs_cpu_max_abs_err": e_gen, "stage_atol": STAGE_ATOL,
         "reconstructor_gpu_vs_cpu_max_abs_err": e2e,
         "batched_n64_vs_cpu_max_abs_err": e2e_batched, "atol": E2E_ATOL,
         "bf16_vs_f32_max_abs": float(d16.max()),
         "bf16_vs_f32_mean_abs": float(d16.mean())})
    if not (e_enc <= STAGE_ATOL and e_gen <= STAGE_ATOL):
        fail(f"encoder / sampler on the card differ from the CPU by {e_enc} "
             f"/ {e_gen} > {STAGE_ATOL}")
    if not (e2e <= E2E_ATOL and e2e_batched <= E2E_ATOL):
        fail(f"reconstructor on the card differs from the CPU by {e2e} / "
             f"{e2e_batched} > {E2E_ATOL}")
    if not d16.mean() < 0.05:
        fail(f"bf16 reconstructor strays from f32: mean |Δ| {d16.mean()}")
    torch.cuda.synchronize()
    return run_dirs


# device-time groups of a dispatch, by substrings of the kernel's name
GROUPS = (("K1 fused_conv", ("conv2d_bias_act_kernel",)),
          ("K2a bn_stats", ("bn_stats_partial_kernel",
                            "bn_stats_merge_kernel")),
          ("K2b bn_apply", ("bn_apply_kernel",)),
          ("transpose conv (cuDNN)", ("dgrad", "conv", "xmma", "cudnn",
                                      "implicit_gemm", "sm90_")),
          ("matmul", ("gemm", "cutlass", "ampere_", "magma")))
DISPATCH_REPS = 20


def _group(name: str) -> str:
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def _profile(call, x):
    """(device busy / wall time, device ms per call by group, the largest
    kernels) of ``DISPATCH_REPS`` calls under ``torch.profiler``; the
    profiler's own host cost lengthens the wall time, so the busy share is
    a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DISPATCH_REPS):
            call(0, x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    groups, top, busy_us = {}, [], 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or ev.device_type == DeviceType.CPU:
            continue  # host-side ops, whose device time their kernels hold
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
        top.append((dev_us, ev.key[:90]))
        busy_us += dev_us
    per_call = {k: v / 1e3 / DISPATCH_REPS for k, v in sorted(groups.items())}
    top = [[name, us / 1e3 / DISPATCH_REPS]
           for us, name in sorted(top)[::-1][:8]]
    return busy_us / 1e3 / wall_ms, per_call, top


def phase_dispatch(run_dirs):
    """Where one serving dispatch spends its time, per compute dtype, entry
    and bucket, on the run directories of the serve phase: ``call_ms`` is
    the host wall time of the server's call (numpy in, numpy out), median
    of ``DISPATCH_REPS``; ``device_ms`` the forward alone on inputs already
    on the card (``time_ms``), as served (deterministic cuDNN) and with
    cuDNN free to pick its algorithms; then ``_profile``'s busy share and
    device time by group."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.serve.export import make_entry
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    from graphical_gan_tpu_torch.tools.generate import rebuild, restore_params
    from graphical_gan_tpu_torch.train.checkpoint import latest
    rng = np.random.default_rng(0)
    for dtype, run_dir in run_dirs.items():
        family, cfg, model = rebuild(run_dir)
        params, _ = restore_params(model, latest(run_dir), "cuda")
        for entry in ("sampler", "encoder", "reconstructor"):
            call, kinds, _, _ = sampler_from_run_dir(run_dir, entry=entry,
                                                     device="cuda")
            fn, _, _ = make_entry(family, model, entry)
            for b in BUCKETS:
                if kinds == ["image"]:
                    x = rng.integers(0, 256, (b, cfg.data.output_dim)
                                     ).astype(np.float32)
                else:
                    x = rng.standard_normal((b, cfg.dim_latent),
                                            dtype=np.float32)
                call(0, x)
                host = []
                for _ in range(DISPATCH_REPS):
                    t0 = time.perf_counter()
                    call(0, x)
                    host.append((time.perf_counter() - t0) * 1e3)
                busy, groups, top = _profile(call, x)
                xd = torch.tensor(x, device="cuda")
                with torch.inference_mode():
                    dev = time_ms(lambda a: fn(params, 0, a), (xd,))
                    torch.backends.cudnn.deterministic = False
                    try:
                        dev_free = time_ms(lambda a: fn(params, 0, a), (xd,))
                    finally:
                        torch.backends.cudnn.deterministic = True
                log({"dispatch": {
                    "entry": entry, "dtype": dtype, "B": b,
                    "call_ms": statistics.median(host), "device_ms": dev,
                    "device_ms_cudnn_nondeterministic": dev_free,
                    "busy_share": busy, "device_ms_by_group": groups,
                    "top_kernels_ms": top}})


SOURCES = {
    "fused_conv2d_bias_act": (
        "graphical_gan_tpu_torch/csrc/fused_conv.cu",
        "graphical_gan_tpu/ops/pallas/fused_conv.py:135"),
    "bn_stats": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                 "graphical_gan_tpu/ops/pallas/fused_norm.py:143"),
    "bn_apply": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                 "graphical_gan_tpu/ops/pallas/fused_norm.py:182"),
}


def summary(errs, timings, launch_totals):
    """One entry per kernel: times summed over the shapes of one
    reconstructor dispatch at B=256 in f32."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        rows = [r for r in timings if r["kernel"] == name and r["B"] == 256
                and r["dtype"] == "float32"]
        if name == "bn_stats":  # E.BN2 and G.BN2 share one timed row
            rows = rows + [r for r in rows if r["shape"] == "E.BN2"]

        def total(key):
            return sum(r[key] for r in rows)
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": launch_totals[name],
                    "max_abs_err": errs[name],
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"),
                    "bound_by": ("operations" if ops_ms >= bytes_ms
                                 else "bytes"),
                    "library_ms": total("library_ms")})
    return {"kernels": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log", default=None,
                   help="also write every logged line to this file")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    try:
        try:
            import torch
        except ImportError as e:
            fail(f"torch is not importable: {e}")
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this smoke run needs "
                 "a card")
        sys.path.insert(0, ROOT)
        try:
            import graphical_gan_tpu_torch
        except ImportError as e:
            fail(f"the port package is not beside chip_smoke.py: {e}")
        pkg_dir = os.path.dirname(os.path.abspath(
            graphical_gan_tpu_torch.__file__))
        if os.path.dirname(pkg_dir) != ROOT:
            fail(f"graphical_gan_tpu_torch was imported from {pkg_dir}, not "
                 f"from this checkout")
        card = phase_device()
        # full-f32 products and convolutions for the plain versions and the
        # library calls (cuDNN defaults to TF32 for f32 convolutions)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        errs, timings, launch_totals = {}, [], {}
        phase_build()
        phase_check(errs)
        phase_time(timings)
        run_dirs = phase_serve(launch_totals)
        missing = [k for k in SOURCES if not launch_totals.get(k)]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")
        phase_dispatch(run_dirs)
        if "jax" in sys.modules or "graphical_gan_tpu" in sys.modules:
            fail("JAX or the JAX package was imported")
        log(summary(errs, timings, launch_totals))
        log({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                               1)})
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if args.log:
            os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                        exist_ok=True)
            with open(args.log, "w") as f:
                f.write("\n".join(_LINES) + "\n")


if __name__ == "__main__":
    sys.exit(main())
