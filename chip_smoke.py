#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX or of the JAX package, and does in order:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles ``graphical_gan_tpu_torch/csrc/*.cu`` with nvcc and
   requires ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA load) instructions
   in the library's SASS;
3. check: holds each kernel (K1 conv+bias+act, K2a BN stats in one
   launch, K2b BN apply, K2c+K2d the BN backward in one launch, K3a/K3b
   conv_gemm taps and im2col) against its plain PyTorch version at every
   serving and training shape, B in {8, 64, 256}, f32 and bf16, plus BN
   inputs with a large mean (K2a's variance also against f64); K2a and the
   BN backward (with every activation) at edge shapes (R under one unit, C
   3 and 4096, ragged row blocks, one shape whose g and x do not fit in
   shared memory, one where a block takes two units), each K2a and BN
   backward call made twice for the same bits, and K2a's kernels under
   ``torch.profiler`` (one per call); K1 and K2 at the mnist and celeba
   shapes and at the metric classifier's (3x3 stride 2, f32, cifar10 and
   mnist, at every batch size the eval and learn phases and the sensitivity
   tool run it at: 96 / 100 / 256 / 464 / 512 / 4096 / 5000 / 10000,
   ``classifier_batches``), and K2a/K2b at G's BN shapes where G samples
   from f32 codes (B 100 and 128); K3a and K3b at
   their bench shapes, the JAX tests' shapes and a non-square input, f32
   and bf16, with and without the leaky epilogue, each called twice for the
   same bits, and bit-equal to each other and to K1 where one plan runs
   them (every f32 shape, bf16 at Cin % 64 == 0); the K1 autograd
   Function's first- and second-order
   gradients, and the BN + act double backward (mnist D.BN2/D.BN3),
   against plain autograd; every K1 kernel and every path of K1's plan
   with one split and with several, each called twice for the same bits;
4. time: per kernel and shape, the kernel's median time from CUDA events
   on inputs that are not in L2 (``tools/timing.py``), its plain
   version's, one PyTorch library call's, and the bound (bytes over
   3.35 TB/s or the operations the function needs, taps in the padding
   left out, over 67 TFLOP/s f32 / 989 TFLOP/s bf16); K3 in f32 and bf16
   at the bench shapes, with each variant's route;
5. serve: writes a full-width cifar10 wali-gp run directory (random
   weights from a seed), serves the sampler, encoder and reconstructor
   entries over HTTP on localhost through the port's server, checks the
   outputs and that every dispatch went through the kernels, and compares a
   64-row reconstruction with the same model on the CPU;
6. dispatch: per dtype, entry and bucket, a dispatch's host and device
   time, its device busy share, its device time and kernels by group (no
   more than one K2a kernel per BN forward);
7. train: the port's Trainer at the published cifar10 wali-gp config
   (B=64, DIM=64, z=128, k=5) on a resident synthetic 50k set, in f32 and
   bf16: finite costs, every kernel launched, ms per iteration, images/s,
   busy share and device time by group; then 2 iterations on the card
   against the CPU from the same params, batches and noise, two runs from
   one seed bit for bit, and a resumed run against an uninterrupted one;
8. bench-conv: K3's own path, ``tools/bench_conv_kernel.main()`` (four
   bf16 shapes, the library arm beside K3a and K3b); K3a must run its TMA
   mainloop there, and K1's counter must not count K3's calls;
9. family1: 3 Trainer iterations of each of the 13 modes on mnist (B=50,
   DIM=64) and of celeba ali (B=128, dim 32) at published widths on
   resident synthetic data: finite costs, each mode's kernels launched,
   K2c+K2d inside the mnist wali-gp penalty's backward; then mnist ali and
   wali-gp (k = 2) 2 iterations on the card against the CPU (the same
   checks and controls as train-parity) and one mnist reconstructor
   dispatch;
10. loaders: cifar10 wali-gp at the published config, 3 iterations
   through ``runs/gan_inference.run`` on CIFAR-10 pickle batches written
   here, resident (the pool is the written train rows) and host-fed (every
   batch through the prefetcher's side stream);
11. eval: 100 iterations of cifar10 wali-gp in bf16 on the structured
   family with the sample grids every 50 and the quality hook at 100: the
   grid PNGs at their sizes (read from their IHDR), the dev cost at
   iteration 99, finite IS / FID / classifier accuracy, no TSNE line;
12. learn: ``tools/sensitivity.py --checkpoints 0,500 --n-score 5000``
   (bf16, published width): classifier held-out accuracy >= 0.95, real IS
   >= 8.0, noise IS <= 2.0, IS up and FID down from iteration 0 to 500;
   and PIL, matplotlib and sklearn never imported;
13. prints one JSON line per kernel summary, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. ``--log PATH`` also
writes every logged line to PATH. Each phase logs its seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
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
    # stats are f32 in both dtypes; K2a's f64 sums against the plain
    # version's f32 two-pass order
    ("stats", "float32"): (1e-5, 1e-4),
    ("stats", "bfloat16"): (1e-5, 1e-4),
    # apply: one fused multiply-add vs two roundings; bf16 output rounding
    ("apply", "float32"): (1e-5, 1e-5),
    ("apply", "bfloat16"): (1e-2, 1e-2),
    # K2c+K2d's dx: the plain formula with other fused multiply-adds and
    # sums in another order, terms of order |g|·inv·scale; bf16 output
    # rounding
    ("bwd_apply", "float32"): (1e-5, 1e-5),
    ("bwd_apply", "bfloat16"): (1e-2, 1e-2),
    # K1's gradients: the same cuDNN gradient calls on both sides, fed by
    # K1's or the plain forward's output (f32 within 1e-4 of each other);
    # atol scales with max(1, max |ref|)
    ("conv_bwd", "float32"): (1e-4, 1e-4),
    ("conv_bwd", "bfloat16"): (1e-2, 1e-2),
}
# K2c+K2d's red: f32 sums of R terms in another order; |Δ| <= 1e-5 of the
# sum of the terms' magnitudes per channel
RED_RTOL = 1e-5
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
    """The port's timer (``graphical_gan_tpu_torch/tools/timing.py``):
    median device ms of one call, inputs rotated out of L2."""
    from graphical_gan_tpu_torch.tools.timing import time_ms as timer
    return timer(fn, args, reps, inner)


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
             if any(k in ln for k in ("registers", "spill", "Compiling entry",
                                      "wgmma", "Performance"))]
    hgmma = _sass_count(path, "HGMMA")
    utmaldg = _sass_count(path, "UTMALDG")
    log({"phase": "build", "seconds": round(secs, 3),
         "library": os.path.relpath(path, ROOT),
         "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
         "sass_hgmma_instructions": hgmma,
         "sass_utmaldg_instructions": utmaldg})
    for ln in ptxas:
        log("ptxas: " + ln)
    if not hgmma:
        fail("no HGMMA instruction in the library's SASS: K1's bf16 path "
             "does not run on wgmma")
    if not utmaldg:
        fail("no UTMALDG instruction in the library's SASS: K3a's mainloop "
             "issues no TMA load")


def _sass_count(lib_path: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of ``lib_path``
    (``cuobjdump -sass``, from the CUDA toolkit)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    return sum(1 for ln in res.stdout.splitlines() if opcode in ln)


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


def _bn_cotangents(x, gen):
    """Two cotangents for K2c+K2d: one drawn apart from x, and one that
    follows x per channel (g = c·x + d + noise), so that the centring terms
    Σgz/R and xhat·Σ(gz·xhat)/R are of the order of gz itself in both
    dtypes, not O(1/√R) of it."""
    import torch
    r, c = x.shape
    noise = torch.randn((r, c), generator=gen, device="cuda")
    cc = torch.randn((c,), generator=gen, device="cuda")
    dd = torch.randn((c,), generator=gen, device="cuda")
    return (("", noise.to(x.dtype)),
            ("+corr", (x.float() * cc + dd + noise).to(x.dtype)))


# shapes off the serving path that reach the kernels' edge handling: odd
# sizes, stride 1, VALID, 1x1, Cin 1, Cout not a multiple of the 64-wide
# tile; BN with C not a multiple of 4 (scalar apply) and ragged row blocks
EDGE_CONV = [("odd7", (2, 7, 7, 8), 16, 5, 2, "SAME", "relu"),
             ("s1", (2, 9, 9, 8), 8, 3, 1, "SAME", "leaky_relu"),
             ("valid", (2, 12, 12, 8), 8, 5, 2, "VALID", None),
             ("1x1", (2, 8, 8, 8), 24, 1, 1, "SAME", None),
             ("cin1", (3, 5, 5, 1), 70, 3, 1, "SAME", "leaky_relu")]
# shapes that give K1's plan the kernels and splits no model shape picks:
# fma's 128 x 128 tile with element gathers, a split mma (Cin 6) in bf16,
# and a split whose last step is ragged (R = 800, 12.5 steps of 64)
K1_COVER = [("cin3 to 128", (128, 32, 32, 3), 128, 5, 2, "SAME",
             "leaky_relu"),
            ("split 64x64", (2, 9, 9, 32), 64, 5, 2, "SAME", "relu"),
            ("cin6 k7", (2, 9, 9, 6), 16, 7, 1, "SAME", "leaky_relu")]
# every kernel of csrc/fused_conv*.cu: (path, 16-byte gathers, BM, BN)
K1_KERNELS = ({("wgmma", True, bm, bn) for bm in (64, 128) for bn in (64, 128)}
              | {("mma", False, 64, 64)}
              | {("fma", v, bm, bn) for v in (True, False)
                 for bm, bn in ((128, 128), (64, 64), (32, 64))})
EDGE_BN = [("r196", (196, 16), "relu"), ("c5", (3, 5), "leaky_relu"),
           ("c130", (1000, 130), None), ("c4100", (7, 4100), "relu"),
           ("r5 one unit", (5, 16), "leaky_relu"),
           ("c3", (777, 3), "relu"), ("c4096", (33, 4096), None),
           ("l2 reread", (90000, 96), "leaky_relu"),
           # 133 channel tiles: a block takes two units, in its second slot
           ("two units a block", (9, 67590), "relu")]


# the rest of family 1 at its published widths: mnist (B=50, DIM=64; E and
# D convs 28 -> 14 -> 7 -> 4, Cin 1; BN in E, G and the mnist D) and celeba
# (B=128, dim 32; four convs 64 -> 32 -> 16 -> 8 -> 4, no BN)
MNIST_CONV = [("mnist E/D.1", (50, 28, 28, 1), 64, "leaky_relu"),
              ("mnist E/D.2", (50, 14, 14, 64), 128, None),
              ("mnist E/D.3", (50, 7, 7, 128), 256, None)]
CELEBA_CONV = [("celeba E/D.1", (128, 64, 64, 3), 32, "leaky_relu"),
               ("celeba E/D.2", (128, 32, 32, 32), 64, "leaky_relu"),
               ("celeba E/D.3", (128, 16, 16, 64), 128, "leaky_relu"),
               ("celeba E/D.4", (128, 8, 8, 128), 256, "leaky_relu")]
MNIST_BN = [("mnist E/D.BN2", (49 * 50, 128), "leaky_relu"),
            ("mnist E/D.BN3", (16 * 50, 256), "leaky_relu"),
            ("mnist G.BN1", (50, 4096), "relu"),
            ("mnist G.BN2", (64 * 50, 128), "relu"),
            ("mnist G.BN3", (196 * 50, 64), "relu")]
# the metric classifier (metrics/classifier.py) at its widths in the quality
# hook and tools/sensitivity.py (dim 32): three 3x3 stride-2 SAME convs,
# f32, the first with the leaky ReLU in K1's epilogue, and BN2 / BN3 with
# the leaky ReLU, on cifar10 (32x32, Cin 3) and mnist (28x28, Cin 1), at
# the batch sizes of classifier_batches()


def _default(fn, name):
    import inspect
    return inspect.signature(fn).parameters[name].default


def _batches_of(n: int, b: int) -> set:
    """The batch sizes of a pass over n rows in batches of b."""
    return {min(n, b), n % b} - {0}


def _clf_batch_sizes():
    """(fit's, accuracy's, the IS pass's) batch sizes, their defaults."""
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.metrics.inception import get_inception_score
    return (_default(MetricClassifier.fit, "batch_size"),
            _default(MetricClassifier.accuracy, "batch_size"),
            _default(get_inception_score, "batch_size"))


def quality_hook_batches(n_score: int, n_train: int, n_eval: int) -> set:
    """The classifier's batch sizes in runs/gan_inference.py:
    make_structured_quality_hook: fit, accuracy over the n_eval held-out
    rows, the real pool's feature pass (at most n_score rows), and the
    samples' IS batches and feature pass."""
    fit_b, acc_b, is_b = _clf_batch_sizes()
    return ({fit_b, min(n_score, n_train), n_score}
            | _batches_of(n_eval, acc_b) | _batches_of(n_score, is_b))


def sensitivity_batches(argv) -> set:
    """The classifier's batch sizes in tools/sensitivity.py with ``argv``:
    fit, accuracy over the held-out rows, the train rows' feature pass, and
    IS batches and a feature pass over each of the held-out anchor, the
    noise anchor and the samples."""
    from graphical_gan_tpu_torch.tools import sensitivity
    args = sensitivity.parse_args(argv)
    fit_b, acc_b, is_b = _clf_batch_sizes()
    n_anchor = min(args.n_score, sensitivity.N_HELDOUT)
    out = {fit_b, min(args.n_score, args.n_data)}
    out |= _batches_of(sensitivity.N_HELDOUT, acc_b)
    for n in (n_anchor, args.n_score):
        out |= {n} | _batches_of(n, is_b)
    return out


def classifier_batches() -> tuple:
    """Every batch size the classifier runs at in the eval phase (the
    quality hook at its defaults on the structured pool), the learn phase
    (LEARN_ARGS) and tools/sensitivity.py at its defaults."""
    from graphical_gan_tpu_torch.data import pools
    from graphical_gan_tpu_torch.runs.gan_inference import (
        make_structured_quality_hook)
    hook = quality_hook_batches(
        _default(make_structured_quality_hook, "n_score"),
        _default(pools.structured_loaders, "n_train"),
        _default(pools.structured_loaders, "n_eval"))
    return tuple(sorted(hook | sensitivity_batches(LEARN_ARGS)
                        | sensitivity_batches([])))


def generator_sample_batches() -> tuple:
    """The batch sizes G samples at from f32 codes in the eval and learn
    phases: the quality hook's and tools/sensitivity.py's sample batches,
    and cifar10's sample grid (n_vis)."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.runs.gan_inference import (
        make_structured_quality_hook)
    from graphical_gan_tpu_torch.tools.sensitivity import draw_gan_samples
    return tuple(sorted({
        _default(make_structured_quality_hook, "sample_batch"),
        _default(draw_gan_samples, "batch"),
        gan_inference_defaults("cifar10", "wali-gp").n_vis}))


def classifier_shapes(b: int, hw: int, cin: int, dim: int = 32):
    """(conv rows: name, x NHWC, Cout, act; BN rows: name, (R, C), act)."""
    h2, h4, h8 = -(-hw // 2), -(-hw // 4), -(-hw // 8)
    tag = "cifar10" if cin == 3 else "mnist"
    conv = [(f"clf {tag} 1", (b, hw, hw, cin), dim, "leaky_relu"),
            (f"clf {tag} 2", (b, h2, h2, dim), 2 * dim, None),
            (f"clf {tag} 3", (b, h4, h4, 2 * dim), 4 * dim, None)]
    bn = [(f"clf {tag} BN2", (b * h4 * h4, 2 * dim), "leaky_relu"),
          (f"clf {tag} BN3", (b * h8 * h8, 4 * dim), "leaky_relu")]
    return conv, bn


# tools/bench_conv_kernel.py's shapes of K3 (conv_gemm): (name, B, H=W,
# Cin, Cout), 5x5 stride 2 SAME, bias, leaky, bf16 in the bench
K3_SHAPES = [("disc2", 64, 16, 64, 128), ("disc3", 64, 8, 128, 256),
             ("disc2_b512", 512, 16, 64, 128),
             ("disc3_b512", 512, 8, 128, 256)]
# K3 checks: the bench shapes, tests/test_conv_gemm.py's shapes, a
# non-square input, and one whose axes have other SAME pads (H 16: 1 and 2,
# W 13: 2 and 2), which tells the im2col map's W and H corners apart:
# (name, B, H, W, Cin, Cout)
K3_CHECK = [(n, b, h, h, ci, co) for n, b, h, ci, co in K3_SHAPES] + [
    ("jax disc2-like", 4, 16, 16, 128, 256),
    ("jax disc3-like", 4, 8, 8, 256, 512),
    ("jax stem-like", 2, 32, 32, 8, 128),
    ("jax odd H", 6, 12, 12, 16, 128),
    ("non-square", 4, 16, 12, 64, 128),
    ("pads differ", 4, 16, 13, 64, 128)]
# the BN double backward against plain autograd: f32 sums in other orders
# through the statistics, atol scaled by max(1, max |ref|)
DOUBLE_BWD_ATOL = 1e-4


def _route_of(x, w, variant):
    from graphical_gan_tpu_torch.ops.kernels import conv_gemm as k3
    p = k3.route(tuple(x.shape), tuple(w.shape), 2, x.dtype, variant)
    return {"path": p.path, "tile": [p.bm, p.bn], "splits": p.splits}


def _check_k3(label, x, w, bias, leak, errs, misses):
    """K3a and K3b against conv_gemm_plain on the same inputs, each called
    twice for the same bits. Where one plan runs both (f32: K1's ``fma``;
    bf16 at Cin % 64 == 0: K3a's TMA steps are K1's flattened steps on the
    same tile and splits) K3a, K3b and K1 (slope 0.2 or no activation) must
    agree bit for bit."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import conv_gemm as k3
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    dn = str(x.dtype).split(".")[1]
    want = k3.conv_gemm_plain(x, w, bias, 2, leak)
    atol, rtol = TOL[("conv", dn)]
    out, routes, repeat, got = {}, {}, {}, {}
    for variant in k3.VARIANTS:
        got[variant] = k3.conv_gemm(x, w, bias, 2, leak, variant=variant)
        again = k3.conv_gemm(x, w, bias, 2, leak, variant=variant)
        torch.cuda.synchronize()
        routes[variant] = _route_of(x, w, variant)
        name = f"conv_gemm_{variant}"
        e, bad = max_err(got[variant], want, atol, rtol)
        out[variant] = e
        repeat[variant] = torch.equal(got[variant], again)
        errs[name] = max(errs.get(name, 0.0), e)
        if bad or got[variant].dtype != x.dtype or \
                got[variant].shape != want.shape:
            misses.append(f"K3 {variant} {label} {dn} leak={leak}")
        if not repeat[variant]:
            misses.append(f"K3 {variant} {label} {dn} leak={leak} differs "
                          "between two calls")
    one_plan = x.dtype == torch.float32 or x.shape[3] % 64 == 0
    same_as_k1 = None
    if one_plan:
        k1 = fused_conv.fused_conv2d_bias_act(
            x, w, bias, 2, "SAME", None if leak is None else "leaky_relu")
        same_as_k1 = all(torch.equal(got[v], k1) for v in k3.VARIANTS)
        if not same_as_k1:
            misses.append(f"K3 {label} {dn} leak={leak}: K3a, K3b and K1 "
                          "differ under one plan")
    log({"check": "K3", "shape": label, "dtype": dn, "leak": leak,
         "routes": routes, "max_abs_err": out, "atol": atol, "rtol": rtol,
         "two_calls_bit_identical": repeat,
         "k3a_k3b_k1_bit_identical": same_as_k1})


def _check_bn_double_bwd(label, rc, act, gen, errs, misses):
    """FusedBatchNormAct (K2a-d, the plain second-order term) against
    plain autograd of the plain forward, f32: h = Σ gx² + Σ gs·ws + Σ go·wo
    of the first-order gradient (gx, gs, go) of Σ c·act(bn(x)), and h's
    gradient w.r.t. x, scale and offset."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm

    def plain(x, scale, offset, act_):
        mean, _, inv = fused_norm.bn_stats_plain(x)
        return fused_norm.bn_apply_plain(x, mean, inv, scale, offset, act_)

    x, scale, offset = _bn_inputs(rc, torch.float32, gen)
    c = torch.randn(rc, generator=gen, device="cuda")
    ws, wo = (torch.randn((rc[1],), generator=gen, device="cuda")
              for _ in range(2))
    sides = []
    for fn in (fused_norm.fused_batchnorm_act, plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, scale, offset)]
        gx, gs, go = torch.autograd.grad((c * fn(*leaves, act)).sum(),
                                         leaves, create_graph=True)
        h = gx.square().sum() + (gs * ws).sum() + (go * wo).sum()
        grads = torch.autograd.grad(h, leaves, allow_unused=True)
        sides.append([h] + [torch.zeros_like(t) if g is None else g
                            for g, t in zip(grads, leaves)])
    torch.cuda.synchronize()
    out, bad = {}, False
    for name, got, want in zip(("h", "dx", "dscale", "doffset"), *sides):
        e, miss = max_err(got.detach(), want.detach(), DOUBLE_BWD_ATOL * max(
            1.0, float(want.abs().max())), 0.0)
        out[name] = e
        bad |= miss
    errs["bn_double_backward"] = max(errs.get("bn_double_backward", 0.0),
                                     *out.values())
    log({"check": "K2 double backward", "shape": label, "R": rc[0],
         "C": rc[1], "act": act, "max_abs_err": out,
         "atol_times_max1_ref": DOUBLE_BWD_ATOL, "ok": not bad})
    if bad:
        misses.append(f"K2 double backward {label}")


def _check_family1(gen, errs, misses, seen):
    """K1 and K2a-d at the mnist and celeba shapes, K3a/K3b at theirs, and
    the BN double backward at mnist D.BN2 / D.BN3."""
    import torch
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, cout, act in MNIST_CONV + CELEBA_CONV:
            x, w, bias = _conv_inputs(shape, cout, dtype, gen)
            _check_conv(name, x, w, bias, 2, "SAME", act, errs, misses,
                        seen)
        for name, rc, act in MNIST_BN:
            x, scale, offset = _bn_inputs(rc, dtype, gen)
            _check_bn(name, x, scale, offset, act, 0.0, errs, misses)
            for kind, g in _bn_cotangents(x, gen):
                _check_bn_bwd(name + kind, x, g, scale, offset, act, errs,
                              misses)
        for i, (name, b, h, wd, cin, cout) in enumerate(K3_CHECK):
            x = torch.randn((b, h, wd, cin), generator=gen, device="cuda")
            w = torch.randn((5, 5, cin, cout), generator=gen,
                            device="cuda") * 0.05
            bias = torch.randn((cout,), generator=gen, device="cuda")
            args = [t.to(dtype) for t in (x, w, bias)]
            for leak in (0.2, None):
                _check_k3(name, *args, leak, errs, misses)
    for name, rc, act in MNIST_BN[:2]:
        _check_bn_double_bwd(name.replace("E/", ""), rc, act, gen, errs,
                             misses)


def _check_classifier(gen, errs, misses, seen):
    """K1, K2a/K2b and K2c+K2d at the metric classifier's shapes, f32 (its
    dtype, as in JAX), at every batch size the eval and learn phases run
    it at; then K2a/K2b at G's BN shapes where G samples from f32 codes."""
    import torch
    batches = classifier_batches()
    log({"check": "classifier batches", "B": list(batches),
         "G_sample_B": list(generator_sample_batches())})
    for b in generator_sample_batches():
        for name, rc, act in bn_shapes(b):
            if name.startswith("G."):
                x, scale, offset = _bn_inputs(rc, torch.float32, gen)
                _check_bn(f"{name} sample B={b}", x, scale, offset, act, 0.0,
                          errs, misses)
    for hw, cin in ((32, 3), (28, 1)):
        for b in batches:
            conv, bn = classifier_shapes(b, hw, cin)
            for name, shape, cout, act in conv:
                x, w, bias = _conv_inputs(shape, cout, torch.float32, gen, 3)
                _check_conv(f"{name} B={b}", x, w, bias, 2, "SAME", act,
                            errs, misses, seen)
            for name, rc, act in bn:
                x, scale, offset = _bn_inputs(rc, torch.float32, gen)
                _check_bn(f"{name} B={b}", x, scale, offset, act, 0.0, errs,
                          misses)
                for kind, g in _bn_cotangents(x, gen):
                    _check_bn_bwd(f"{name}{kind} B={b}", x, g, scale, offset,
                                  act, errs, misses)


def _plan_of(x, w, stride, padding):
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    return fused_conv.plan(tuple(x.shape), tuple(w.shape), stride, padding,
                           x.dtype)


def _check_conv(label, x, w, bias, stride, padding, act, errs, misses,
                seen):
    """K1 against its plain version, and a second call on the same inputs
    for the same bits; ``seen`` collects the plans' kernels and paths."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    dn = str(x.dtype).split(".")[1]
    got = fused_conv.fused_conv2d_bias_act(x, w, bias, stride, padding, act)
    again = fused_conv.fused_conv2d_bias_act(x, w, bias, stride, padding,
                                             act)
    want = fused_conv.fused_conv2d_bias_act_plain(x, w, bias, stride,
                                                  padding, act)
    torch.cuda.synchronize()
    p = _plan_of(x, w, stride, padding)
    seen.add((p.path, p.vec, p.bm, p.bn))
    seen.add((p.path, p.vec, p.splits > 1))
    atol, rtol = TOL[("conv", dn)]
    e, bad = max_err(got, want, atol, rtol)
    same = torch.equal(got, again)
    errs["fused_conv2d_bias_act"] = max(
        errs.get("fused_conv2d_bias_act", 0.0), e)
    log({"check": "K1", "shape": label, "dtype": dn, "max_abs_err": e,
         "atol": atol, "rtol": rtol, "path": p.path, "vec": p.vec,
         "tile": [p.bm, p.bn], "splits": p.splits,
         "two_calls_bit_identical": same, "ok": not bad and same})
    if bad or got.dtype != x.dtype or got.shape != want.shape:
        misses.append(f"K1 {label} {dn}")
    if not same:
        misses.append(f"K1 {label} {dn} differs between two calls")


def _check_f32_against_cpu():
    """The share of K1's f32 outputs equal bit for bit to the plain version
    on this host's CPU, at the cifar10 training shapes and mnist's: f32 K1
    sums each output in the order of PyTorch's CPU convolution at Cin >= 2
    (1.0 there; mnist's Cin = 1 takes another CPU algorithm), and the f32
    card-against-CPU parity phases lean on that (logged, not held: the CPU
    library's order is not K1's to set)."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    share = {}
    for name, shape, cout, act in conv_shapes(64) + MNIST_CONV:
        x, w, bias = _conv_inputs(shape, cout, torch.float32, gen)
        got = fused_conv.fused_conv2d_bias_act(x, w, bias, 2, "SAME", act)
        want = fused_conv.fused_conv2d_bias_act_plain(
            x.cpu(), w.cpu(), bias.cpu(), 2, "SAME", act)
        share[name] = float((got.cpu() == want).float().mean())
    log({"check": "K1 f32 against the CPU", "bit_equal_share": share})


def _k1_coverage_misses(seen):
    """The K1 kernels and the (path, gathers, split) kinds no check ran; f32
    (``fma``) is never split."""
    kinds = {(path, vec, split) for path, vec, _, _ in K1_KERNELS
             for split in (False, path != "fma")}
    return sorted(str(k) for k in (K1_KERNELS | kinds) - seen)


def _check_bn(label, x, scale, offset, act, mean, errs, misses):
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    dn = str(x.dtype).split(".")[1]
    m, v, inv = fused_norm.bn_stats(x)
    m2, v2, inv2 = fused_norm.bn_stats(x)
    pm, pv, pinv = fused_norm.bn_stats_plain(x)
    y = fused_norm.bn_apply(x, pm, pinv, scale, offset, act)
    py = fused_norm.bn_apply_plain(x, pm, pinv, scale, offset, act)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in ((m, m2), (v, v2), (inv, inv2)))
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
    p = fused_norm.bn_stats_plan(*x.shape, x.dtype)
    log({"check": "K2", "shape": label, "dtype": dn, "R": x.shape[0],
         "C": x.shape[1], "stats_units": p.units, "stats_grid": p.grid,
         "stats_max_abs_err": {"mean": es[0], "var": es[1], "inv": es[2]},
         "var_rel_err_vs_f64": rel_var,
         "plain_var_rel_err_vs_f64": rel_var_plain,
         "stats_same_bits_twice": same,
         "apply_max_abs_err": ea, "ok": not (bad_s or bad_a) and same})
    if bad_s:
        misses.append(f"K2a {label} {dn}")
    if not same:
        misses.append(f"K2a not bit-identical {label} {dn}")
    if bad_a or y.dtype != x.dtype:
        misses.append(f"K2b {label} {dn}")


def _check_bn_stats_launches(gen, misses):
    """Each ``bn_stats`` call launches one kernel: ``torch.profiler``'s
    kernel events over 10 calls at each BN shape of a B=256 dispatch, f32
    and bf16, are all ``bn_stats_fused_kernel``, at most one per call (the
    profiler may drop an event, never add one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    xs = [_bn_inputs(rc, dtype, gen)[0]
          for dtype in (torch.float32, torch.bfloat16)
          for _, rc, _ in bn_shapes(256)]
    calls = 10 * len(xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs:
            for _ in range(10):
                fused_norm.bn_stats(x)
        torch.cuda.synchronize()
    kernels = {ev.key[:90]: ev.count for ev in prof.key_averages()
               if ev.device_type != DeviceType.CPU}
    ok = (sum(kernels.values()) <= calls
          and all("bn_stats_fused_kernel" in k for k in kernels))
    log({"check": "K2a launches", "calls": calls, "kernel_events": kernels,
         "ok": ok})
    if not ok:
        misses.append(f"K2a: {kernels} kernel events for {calls} calls")


def _check_bn_bwd(label, x, g, scale, offset, act, errs, misses):
    """K2c+K2d (``bn_bwd``, one launch) against ``bn_bwd_plain``: red
    within RED_RTOL of each channel's mass, dx within the bwd_apply
    tolerance; called twice, both calls must give the same bits."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    dn = str(x.dtype).split(".")[1]
    mean, _, inv = fused_norm.bn_stats_plain(x)
    dx, red = fused_norm.bn_bwd(g, x, mean, inv, scale, offset, act)
    dx2, red2 = fused_norm.bn_bwd(g, x, mean, inv, scale, offset, act)
    pdx, pred = fused_norm.bn_bwd_plain(g, x, mean, inv, scale, offset, act)
    torch.cuda.synchronize()
    same = torch.equal(dx, dx2) and torch.equal(red, red2)
    gz, xhat = fused_norm._gz_xhat(g, x, mean, inv, scale, offset, act)
    mass = torch.stack([gz.abs().sum(0), (gz * xhat).abs().sum(0)])
    e_red = float((red - pred).abs().max())
    bad_red = not bool(torch.isfinite(red).all()) or bool(
        ((red - pred).abs() > RED_RTOL * mass + 1e-6).any())
    atol, rtol = TOL[("bwd_apply", dn)]
    e_dx, bad_dx = max_err(dx, pdx, atol * max(1.0, float(pdx.float().abs()
                                                          .max())), rtol)
    errs["bn_bwd"] = max(errs.get("bn_bwd", 0.0), e_dx)
    errs["bn_bwd_red"] = max(errs.get("bn_bwd_red", 0.0), e_red)
    p = fused_norm.bn_bwd_plan(*x.shape, x.dtype)
    log({"check": "K2c+K2d", "shape": label, "dtype": dn, "act": act,
         "R": x.shape[0], "C": x.shape[1], "units": p.units,
         "onchip": p.onchip, "grid": p.grid, "slots": p.slots,
         "red_max_abs_err": e_red,
         "red_rtol_of_mass": RED_RTOL, "dx_max_abs_err": e_dx,
         "same_bits_twice": same,
         "ok": not (bad_red or bad_dx) and same})
    if bad_red:
        misses.append(f"K2c+K2d red {label} {dn} {act}")
    if bad_dx or dx.dtype != x.dtype:
        misses.append(f"K2c+K2d dx {label} {dn} {act}")
    if not same:
        misses.append(f"K2c+K2d not bit-identical {label} {dn} {act}")


def _check_conv_bwd(label, x, w, bias, errs, misses):
    """conv2d_bias_act (K1 forward, its backward) against plain autograd
    of the plain forward: dx, dw, dbias at a cotangent g, and in f32 the
    penalty's second order, d/dw of ||dx||²."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    dn = str(x.dtype).split(".")[1]
    second = x.dtype == torch.float32
    b, h, wd, _ = x.shape
    g = torch.randn((b, -(-h // 2), -(-wd // 2), w.shape[3]), device="cuda")
    sides = []
    for fn in (fused_conv.conv2d_bias_act,
               fused_conv.fused_conv2d_bias_act_plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, w, bias)]
        y = fn(*leaves, 2, "SAME", "leaky_relu")
        grads = torch.autograd.grad((y.float() * g).sum(), leaves,
                                    create_graph=second)
        if second:
            grads = grads + torch.autograd.grad(
                grads[0].square().sum(), leaves[1])
        sides.append([t.detach() for t in grads])
    torch.cuda.synchronize()
    atol, rtol = TOL[("conv_bwd", dn)]
    out, bad = {}, False
    for name, got, want in zip(("dx", "dw", "dbias", "d2w"), *sides):
        e, miss = max_err(got, want, atol * max(1.0, float(
            want.float().abs().max())), rtol)
        out[name] = e
        bad |= miss
    errs["conv2d_bias_act_backward"] = max(
        errs.get("conv2d_bias_act_backward", 0.0), *out.values())
    log({"check": "K1 backward", "shape": label, "dtype": dn,
         "max_abs_err": out, "atol_times_max1_ref": atol, "rtol": rtol,
         "ok": not bad})
    if bad:
        misses.append(f"K1 backward {label} {dn}")


def phase_check(errs):
    """Each kernel against its plain version on the same inputs; ``errs``
    collects the max |Δ| per kernel."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    misses = []
    seen = set()  # K1's kernels and paths that ran
    for dtype in (torch.float32, torch.bfloat16):
        for b in BUCKETS:
            for name, shape, cout, act in conv_shapes(b):
                x, w, bias = _conv_inputs(shape, cout, dtype, gen)
                _check_conv(f"{name} B={b}", x, w, bias, 2, "SAME", act,
                            errs, misses, seen)
            for name, rc, act in bn_shapes(b):
                for mean in (0.0, 1e3):
                    x, scale, offset = _bn_inputs(rc, dtype, gen, mean)
                    label = f"{name}{'+1e3' if mean else ''} B={b}"
                    _check_bn(label, x, scale, offset, act, mean, errs,
                              misses)
        for b in (64, 256):  # the training shapes
            for name, rc, _ in bn_shapes(b):
                for act in ("relu", "leaky_relu", None):
                    x, scale, offset = _bn_inputs(rc, dtype, gen)
                    for kind, g in _bn_cotangents(x, gen):
                        _check_bn_bwd(f"{name}{kind} B={b}", x, g, scale,
                                      offset, act, errs, misses)
        for name, shape, cout, _ in conv_shapes(64):  # = D.1-3's shapes
            x, w, bias = _conv_inputs(shape, cout, dtype, gen)
            _check_conv_bwd(name.replace("E", "D") + " B=64", x, w, bias,
                            errs, misses)
        for name, shape, cout, k, s, pad, act in EDGE_CONV + K1_COVER:
            x, w, bias = _conv_inputs(shape, cout, dtype, gen, k)
            _check_conv(name, x, w, bias, s, pad, act, errs, misses, seen)
        for name, rc, act in EDGE_BN:
            x, scale, offset = _bn_inputs(rc, dtype, gen)
            _check_bn(name, x, scale, offset, act, 0.0, errs, misses)
            for kind, g in _bn_cotangents(x, gen):
                _check_bn_bwd(name + kind, x, g, scale, offset, act, errs,
                              misses)
    _check_bn_stats_launches(gen, misses)
    _check_family1(gen, errs, misses, seen)
    _check_classifier(gen, errs, misses, seen)
    _check_f32_against_cpu()
    missed = _k1_coverage_misses(seen)
    log({"check": "K1 plan coverage", "kernels_and_paths_run": len(seen),
         "missed": missed})
    if missed:
        misses.append(f"K1 kernels or paths never checked: {missed}")
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
                p = _plan_of(x, w, 2, "SAME")
                row = {"kernel": "fused_conv2d_bias_act", "shape": name,
                       "B": b, "dtype": dn, "card": card, "path": p.path,
                       "tile": [p.bm, p.bn], "splits": p.splits,
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
            for name, rc, act in bn_shapes(b):
                x, scale, offset = _bn_inputs(rc, dtype, gen)
                r, c = rc
                mean, var, inv = fused_norm.bn_stats_plain(x)
                act_fn = activation(act)
                t_b, by = bn_stats_bound(r, c, size)
                p = fused_norm.bn_stats_plan(r, c, dtype)
                row = {"kernel": "bn_stats", "shape": name, "B": b,
                       "dtype": dn, "card": card, "units": p.units,
                       "ms": time_ms(fused_norm.bn_stats, (x,)),
                       "plain_ms": time_ms(fused_norm.bn_stats_plain, (x,)),
                       "library_ms": time_ms(
                           lambda a: torch.var_mean(a, dim=0, correction=0),
                           (x,)),
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
            _time_bn_bwd(timings, b, dtype, gen, card)
    _time_k3(timings, card)


def bn_stats_bound(r: int, c: int, itemsize: int):
    """(bound ms, what bounds it) of K2a on [r, c]: x read once and mean,
    var and inv (3·C f32) written once; about 3 operations per element (an
    add for the sum, a subtract and a fused multiply-add for the squares),
    far under the byte time at the f32 rate (and at the f64 rate the kernel
    sums in)."""
    return bound(3.0 * r * c, r * c * itemsize + 3 * c * 4, "float32")


def bn_bwd_bound(r: int, c: int, itemsize: int):
    """(bound ms, what bounds it) of K2c+K2d on [r, c]: g and x read once
    and dx written once, mean, inv, scale and offset read once (4·C f32) and
    the two sums written once (2·C f32); about 24 f32 operations per element
    (10 for the sums, 14 for dx)."""
    return bound(24.0 * r * c, 3 * r * c * itemsize + 6 * c * 4, "float32")


def _time_bn_bwd(timings, b, dtype, gen, card):
    """K2c+K2d (``bn_bwd``) at the training BN shapes; the library yardstick
    is ``native_batch_norm_backward`` on gz = g·act'(y), the one PyTorch
    call that computes the same function given gz."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    dn = str(dtype).split(".")[1]
    for name, rc, act in bn_shapes(b):
        x, scale, offset = _bn_inputs(rc, dtype, gen)
        g = torch.randn(rc, generator=gen, device="cuda").to(dtype)
        mean, _, inv = fused_norm.bn_stats_plain(x)
        gz = fused_norm._gz_xhat(g, x, mean, inv, scale, offset, act)[0].to(
            dtype)
        lib = time_ms(lambda *a: torch.ops.aten.native_batch_norm_backward(
            *a, None, None, mean, inv, True, 1e-5, [True, True, True]),
            (gz, x, scale))
        args = (g, x, mean, inv, scale, offset)
        t_b, by = bn_bwd_bound(*rc, dtype.itemsize)
        p = fused_norm.bn_bwd_plan(*rc, dtype)
        row = {"kernel": "bn_bwd", "shape": name, "B": b, "dtype": dn,
               "card": card, "units": p.units, "onchip": p.onchip,
               "ms": time_ms(lambda *a: fused_norm.bn_bwd(*a, act), args),
               "plain_ms": time_ms(
                   lambda *a: fused_norm.bn_bwd_plain(*a, act), args),
               "library_ms": lib, "bound_ms": t_b, "bound_by": by}
        timings.append(row)
        log({"timing": row})


def _time_k3(timings, card):
    """K3a and K3b at the bench shapes in f32 and bf16: each kernel's time
    and route, the plain version's (conv_gemm_plain, f32 F.conv2d), the
    library's (F.conv2d + bias + leaky in the same dtype, cuDNN with TF32
    off, channels-last, on input padded beforehand) and the bound (in-bounds
    taps only)."""
    import torch
    import torch.nn.functional as F
    from graphical_gan_tpu_torch.ops.activations import leaky_relu
    from graphical_gan_tpu_torch.ops.kernels import conv_gemm as k3
    from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for name, b, h, cin, cout in K3_SHAPES:
            lo, hi = same_pads(h, 5, 2)
            x = torch.randn((b, h, h, cin), device="cuda", dtype=dtype)
            w = (torch.randn((5, 5, cin, cout), device="cuda") * 0.05).to(
                dtype)
            bias = torch.randn((cout,), device="cuda", dtype=dtype)
            xlib = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi)).contiguous(
                memory_format=torch.channels_last)
            wlib = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            taps = conv_valid_taps(h, 5, 2, lo) ** 2
            oh = -(-h // 2)
            t_b, by = bound(2.0 * b * cout * cin * taps,
                            (b * h * h * cin + b * oh * oh * cout
                             + 25 * cin * cout + cout) * dtype.itemsize, dn)
            lib = time_ms(lambda *a: leaky_relu(F.conv2d(*a, stride=2)),
                          (xlib, wlib, bias))
            plain = time_ms(k3.conv_gemm_plain, (x, w, bias))
            for variant in k3.VARIANTS:
                fn = getattr(k3, f"conv_gemm_{variant}")
                row = {"kernel": fn.__name__, "shape": name, "B": b,
                       "dtype": dn, "card": card, **_route_of(x, w, variant),
                       "ms": time_ms(fn, (x, w, bias)), "plain_ms": plain,
                       "library_ms": lib, "bound_ms": t_b, "bound_by": by}
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
    want = {k: PER_DISPATCH[entry].get(k, 0) * dispatches for k in got}
    log({"phase": "serve", "entry": entry, "warmup_s": round(warmup_s, 3),
         "requests_s": round(secs, 3), "dispatches": dispatches,
         "launches": got, "expected_launches": want, "stats": stats,
         "identity": identity})
    if got != want:
        fail(f"{entry}: kernel launches {got} != {want} "
             f"({dispatches} dispatches)")
    return outs


def phase_serve(launch_totals, k1_counts):
    """The port's main path: the HTTP server over a full-width cifar10
    wali-gp run directory. ``launch_totals`` receives the counts read right
    after the run (all counts were set to 0 right before it), ``k1_counts``
    K1's launches per compute dtype."""
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
    f32_k1 = kernels.launches()["fused_conv2d_bias_act"]
    bf16 = _drive_entry(run_dirs["bfloat16"], "reconstructor", raw, 3072)
    launch_totals.update(kernels.launches())
    k1_counts[("float32", "serve")] = f32_k1
    k1_counts[("bfloat16", "serve")] = \
        launch_totals["fused_conv2d_bias_act"] - f32_k1

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
GROUPS = (("K1 fused_conv", ("conv_k1_",)),
          ("K2a bn_stats", ("bn_stats_fused_kernel",)),
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
    kernels, kernel launches per call by group) of ``DISPATCH_REPS`` calls
    under ``torch.profiler``; the profiler's own host cost lengthens the
    wall time, so the busy share is a lower bound."""
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
    groups, counts, top, busy_us = {}, {}, [], 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us <= 0 or ev.device_type == DeviceType.CPU:
            continue  # host-side ops, whose device time their kernels hold
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us
        counts[g] = counts.get(g, 0) + ev.count
        top.append((dev_us, ev.key[:90]))
        busy_us += dev_us
    per_call = {k: v / 1e3 / DISPATCH_REPS for k, v in sorted(groups.items())}
    top = [[name, us / 1e3 / DISPATCH_REPS]
           for us, name in sorted(top)[::-1][:8]]
    launches = {k: v / DISPATCH_REPS for k, v in sorted(counts.items())}
    return busy_us / 1e3 / wall_ms, per_call, top, launches


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
                busy, groups, top, kernels = _profile(call, x)
                # K2a is one kernel per BN forward (the profiler may drop
                # an event, never add one)
                k2a = kernels.get("K2a bn_stats", 0)
                if k2a > PER_DISPATCH[entry]["bn_stats"]:
                    fail(f"{entry} {dtype} B={b}: {k2a} K2a kernels per "
                         f"dispatch, want one per BN "
                         f"({PER_DISPATCH[entry]['bn_stats']})")
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
                    "kernels_per_call_by_group": kernels,
                    "top_kernels_ms": top}})


# ---------------------------------------------------------------------------
# training: the port's Trainer at the published cifar10 wali-gp config

TRAIN_ITERS = 10     # Trainer iterations per compute dtype (the main path)
TIME_ITERS = 20      # steady-state iterations timed after them
PROFILE_ITERS = 5    # iterations under torch.profiler
REPEAT_ITERS = 4     # iterations of the bit-identity and resume runs
# kernel launches per training iteration: K1 runs E.1-3 and D.1-3 (9 in the
# G update, 12 in each D update: D on real, fake and the interpolates),
# K2a/K2b the 5 BNs of E and G once per update, K2c+K2d the 5 BNs in the
# G update's backward (none at iteration 0, which skips the G update)
PER_ITER = {"fused_conv2d_bias_act": (9 + 12 * 5, 0),
            "bn_stats": (30, 0), "bn_apply": (30, 0),
            "bn_bwd": (5, -5),
            "conv_gemm_taps": (0, 0), "conv_gemm_im2col": (0, 0)}
# device-time groups of a training iteration: the kernel's name first, then
# the autograd node or op that launched it
TRAIN_GROUPS = (
    ("K1 forward", ("conv_k1_",), ()),
    ("K2a-b BN forward", ("bn_stats_fused_kernel", "bn_apply_kernel"), ()),
    ("K2c-d BN backward", ("bn_bwd_fused_kernel",), ()),
    ("BN second order (plain)", (), ("_BatchNormActBackwardBackward",)),
    ("memcpy", ("Memcpy", "Memset"), ()),
    ("optimizer", (), ("aten::_foreach",)),
    ("conv gradients (cuDNN)", (), ("FusedConv2dBiasActBackward",
                                    "ConvolutionBackwardBackward")),
    ("deconv backward", (), ("ConvolutionBackward0",)),
    ("deconv forward", (), ("aten::conv_transpose2d",)),
    ("GEMMs", ("gemm", "cutlass", "ampere_", "sm90_xmma"),
     ("aten::mm", "aten::addmm", "aten::matmul")),
)
# card against CPU after 2 iterations, f32, same params, batches and noise.
# TF1 Adam's first steps are about lr·sign(g): a gradient element near 0
# whose sign differs between the two devices moves its parameter about
# 2·lr the other way (up to 2.6·lr over the first two steps: lr_t·m/√v <
# 1.3·lr at b1 0.5, b2 0.9 or 0.999), which is what happens to the biases
# of the convs before a BN (gradient zero in exact arithmetic) and to the
# odd weight element; so a parameter may differ by SIGN_FLIP_LR·lr per
# update of its player (lr 1e-4 for wali-gp, 2e-4 for ali; G+E: 1 update
# in 2 iterations, D: 2k). That cap alone would pass a step that updated
# nothing, so the state is also held as a whole:
# - each leaf's update (its parameters' move from the initial values), as
#   ‖card − CPU‖₂ / ‖CPU move‖₂ <= UPDATE_RTOL: the sign flips touch few
#   elements (at most 0.099, G.Input.W, on an H100 80GB HBM3 at 700 W),
#   while a skipped update gives 1 and one in the wrong direction 2;
# - Adam's m and v per leaf within MOMENT_RTOL of the leaf's largest
#   element, plus a floor of 1e-7 (m) and 1e-14 (v): G's gradient at
#   iteration 1 is taken at D parameters that already differ by those sign
#   flips, so it differs by more than rounding (at most 1.6e-2 of the
#   leaf's largest, G.Input.W, same card);
# - leaves whose largest m is below NOISE_REL of their player's largest
#   (the biases before a BN, D's output bias) carry rounding noise only and
#   get the cap and, for m and v, a bound at the noise level, NOISE_FLOOR
#   of the player's largest m (its square for v; with BN inside the mnist
#   D's penalty that noise reaches 1.5e-7, the fixed floors' scale), not
#   the update ratio.
# The phase also feeds two wrong states to the same check (a skipped step,
# and every parameter moved the other way) and fails unless both are
# refused at every leaf that the update ratio holds. The first updates'
# gradients are held per leaf: ‖card − CPU‖₂ within GRAD_RTOL of ‖CPU‖₂,
# or of 1e-3 of the player's largest leaf norm, whichever is larger. f32
# sums of up to 16,384 terms in other orders (K1 and cuDNN against the
# CPU's convolutions) give 1e-6 of a leaf; but a ReLU or leaky mask whose
# pre-activation lies within rounding of 0 may flip between the devices
# (about one element per forward in mnist's D.1 output, 627k elements),
# which routes that unit's upstream gradient differently: every G leaf of
# mnist wali-gp then differs by 0.9e-3 to 1.9e-3 of its norm (single
# elements by up to 3e-4; H100 80GB HBM3, 700 W), while a wrong gradient
# formula would differ by O(1).
SIGN_FLIP_LR = 2.6
GRAD_RTOL = 1e-2
UPDATE_RTOL = 0.25
MOMENT_RTOL = 5e-2
NOISE_REL = 1e-4
NOISE_FLOOR = 1e-6
# the mnist wali-gp parity runs k = 2 critic updates (4 D updates in 2
# iterations): at the published k = 5, 10 D updates of TF1 Adam's sign
# amplification through the BNs of the mnist D move G's iteration-1
# gradient enough that Adam's moments differ by up to 6.9% of a leaf's
# largest (G.5.Biases' v; H100 80GB HBM3, 700 W), with the first updates'
# gradients within 1.1e-5 of the CPU's
MNIST_PARITY_K = 2


def _train_group(kernel: str, chain) -> str:
    for label, names, ops in TRAIN_GROUPS:
        if any(k in kernel for k in names) or any(
                o in c for o in ops for c in chain):
            return label
    return "other"


def _profile_train(tr, n):
    """(device busy / wall time, device ms per iteration, device ms per
    iteration by group, the largest kernels, the host's ops per iteration
    and the ops that take the most host time) over ``n`` Trainer iterations
    under torch.profiler, whose own cost inflates the host times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = tr.state.step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            tr.step_fn(tr.state, tr.draw_batches(start + i), True,
                       tr.generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, {}
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or []
        if ev.device_type != DeviceType.CPU or not kernels:
            continue
        chain, q = [], ev
        while q is not None:
            chain.append(q.name)
            q = q.cpu_parent
        for k in kernels:
            g = _train_group(k.name, chain)
            groups[g] = groups.get(g, 0.0) + k.duration / 1e3
            top[k.name[:90]] = top.get(k.name[:90], 0.0) + k.duration / 1e3
    averages = prof.key_averages()
    busy_ms = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        for ev in averages if ev.device_type != DeviceType.CPU)
    per_iter = {k: v / n for k, v in sorted(groups.items())}
    top = [[k, v / n] for k, v in sorted(top.items(), key=lambda kv: -kv[1])
           [:10]]
    host = [ev for ev in averages if ev.device_type == DeviceType.CPU]
    host_ops = sum(ev.count for ev in host if ev.key.startswith("aten::")) / n
    host_top = [[ev.key, ev.self_cpu_time_total / 1e3 / n] for ev in sorted(
        host, key=lambda ev: -ev.self_cpu_time_total)[:8]]
    return (busy_ms / wall_ms, busy_ms / n, per_iter, top, host_ops,
            host_top)


def _time_train(tr, n):
    """Host wall ms per Trainer iteration (batches drawn and gathered on
    the card, one step), ``n`` back to back, ending in a synchronize."""
    import torch
    start = tr.state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        tr.step_fn(tr.state, tr.draw_batches(start + i), True, tr.generator)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _published(dtype):
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    cfg = gan_inference_defaults("cifar10", "wali-gp", compute_dtype=dtype)
    if (cfg.batch_size, cfg.dim, cfg.dim_latent, cfg.critic_iters, cfg.bn) \
            != (64, 64, 128, 5, True):
        fail(f"cifar10 wali-gp defaults changed: {cfg}")
    return GanInferenceModel(cfg)


def _finite_state(tr, label):
    import torch
    bad = [n for n, p in tr.state.params.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        fail(f"{label}: non-finite parameters {bad[:5]}")


def phase_train(launch_totals, data, k1_counts):
    """The training main path: per compute dtype, the counts are set to 0,
    the Trainer runs TRAIN_ITERS iterations, and the counts are read; then
    the steady state is timed and profiled. ``launch_totals`` receives the
    counts summed over both dtypes, ``k1_counts`` K1's per dtype."""
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_train")
    shutil.rmtree(base, ignore_errors=True)
    for dtype in ("float32", "bfloat16"):
        model = _published(dtype)
        tr = Trainer(model, data, os.path.join(base, dtype), seed=0,
                     device="cuda", checkpoint_every=0)
        t0 = time.perf_counter()
        kernels.reset_launches()
        metrics = tr.train(TRAIN_ITERS)
        got = kernels.launches()
        secs = time.perf_counter() - t0
        for k, v in got.items():
            launch_totals[k] = launch_totals.get(k, 0) + v
        k1_counts[(dtype, "train")] = got["fused_conv2d_bias_act"]
        want = {k: a * TRAIN_ITERS + b for k, (a, b) in PER_ITER.items()}
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"train {dtype}: non-finite costs {metrics}")
        _finite_state(tr, f"train {dtype}")
        if got != want:
            fail(f"train {dtype}: kernel launches {got} != {want}")
        ms = _time_train(tr, TIME_ITERS)
        busy, dev_ms, groups, top, host_ops, host_top = _profile_train(
            tr, PROFILE_ITERS)
        per_iter_images = (1 + model.cfg.critic_iters) * model.cfg.batch_size
        log({"phase": "train", "dtype": dtype, "iters": TRAIN_ITERS,
             "seconds": round(secs, 3), "last_metrics": metrics,
             "launches": got, "ms_per_iter": ms,
             "images_per_s": per_iter_images / ms * 1e3,
             "busy_share": busy, "device_ms_per_iter": dev_ms,
             "device_ms_per_iter_by_group": groups,
             "top_kernels_ms_per_iter": top,
             "profiled_host_aten_ops_per_iter": host_ops,
             "profiled_host_self_ms_per_iter_top_ops": host_top})


def _grads(model, params, raw, p_z, alpha, player):
    import torch
    from graphical_gan_tpu_torch.core.registry import merge, partition
    names = model.GEN_PLAYER if player == "gen" else model.DISC_PLAYER
    mine, _ = partition(params, names)
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in mine.items()}
    merged = merge(params, leaves)
    loss = model.gen_loss(merged, raw, p_z=p_z)[0] if player == "gen" \
        else model.disc_loss(merged, raw, p_z=p_z, alpha=alpha)[0]
    return dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))


def phase_train_parity():
    """cifar10 wali-gp: 2 iterations on the card against the CPU."""
    model = _published("float32")
    _train_parity(model, "cifar10 wali-gp", seed=3)


def _parity_inputs(model, seed):
    """Raw batches [2, 1+k, B, D] in the dataset's convention, and the
    noise of 2 iterations: p_z [2, 1+k, B, z] and, for wali-gp, alpha
    [2, k, B, 1]."""
    import numpy as np
    import torch
    cfg = model.cfg
    k, b = cfg.critic_iters, cfg.batch_size
    rng = np.random.default_rng(seed)
    shape = (2, 1 + k, b, cfg.data.output_dim)
    raw = rng.random(shape, dtype=np.float32) \
        if cfg.data.normalization == "unit" \
        else rng.integers(0, 256, shape).astype(np.float32)
    noise = {"p_z": torch.from_numpy(rng.standard_normal(
        (2, 1 + k, b, cfg.dim_latent)).astype(np.float32))}
    if cfg.mode == "wali-gp":
        noise["alpha"] = torch.from_numpy(
            rng.random((2, k, b, 1)).astype(np.float32))
    return torch.from_numpy(raw), noise


def _train_parity(model, label, seed):
    """2 iterations on the card against the CPU (plain versions), f32, from
    the same params, batches and noise; and the first updates' gradients.
    A skipped and a reversed step fed to the same check must be refused."""
    import torch
    from graphical_gan_tpu_torch.train.step import make_train_step
    k = model.cfg.critic_iters
    raw, noise = _parity_inputs(model, seed)
    p_z, alpha = noise["p_z"], noise.get("alpha")
    params = model.init(seed=1, device="cpu")
    dev = {"cpu": torch.device("cpu"), "cuda": torch.device("cuda")}
    grads = {}
    for name, d in dev.items():
        on = {n: p.to(d) for n, p in params.items()}
        grads[name] = {pl: _grads(model, on, raw[0, i].to(d), p_z[0, i].to(d),
                                  None if alpha is None else alpha[0, 0].to(d),
                                  pl)
                       for pl, i in (("gen", 0), ("disc", 1))}
    grad_err, grad_rel, bad = {}, {}, []
    for pl in ("gen", "disc"):
        norm = torch.linalg.vector_norm
        top = max(float(norm(g)) for g in grads["cpu"][pl].values())
        for n, ref in grads["cpu"][pl].items():
            diff = grads["cuda"][pl][n].cpu() - ref
            grad_err[n] = float(diff.abs().max())
            grad_rel[n] = float(norm(diff)) / max(float(norm(ref)), 1e-30)
            if not float(norm(diff)) <= GRAD_RTOL * max(float(norm(ref)),
                                                        1e-3 * top):
                bad.append(f"{n} gradient")
    states = {}
    step, init_state = make_train_step(model)
    for name, d in dev.items():
        # copies: the step updates the parameters in place
        st = init_state({n: p.to(d, copy=True) for n, p in params.items()})
        for it in range(2):
            st, _ = step(st, raw[it].to(d), it > 0,
                         noise={n: t[it].to(d) for n, t in noise.items()})
        states[name] = st
    ref = states["cpu"]
    got = _to_cpu_state(states["cuda"])
    state_bad, report = _state_misses(ref, got, params, model, k)
    # negative controls: a step that updates nothing, and one that moves
    # every parameter the other way, must each fail at every held leaf
    skipped = init_state({n: p.clone() for n, p in params.items()})
    reversed_ = _to_cpu_state(states["cpu"])
    reversed_.params = {n: 2 * params[n] - p for n, p in ref.params.items()}
    held = report["ratio_held_leaves"]
    controls = {}
    for cname, ctrl in (("skipped", skipped), ("reversed", reversed_)):
        cbad, _ = _state_misses(ref, ctrl, params, model, k)
        controls[cname] = sorted(set(held) - {s.split()[0] for s in cbad})
        if controls[cname] or not held:
            bad.append(f"{cname} control passes at {controls[cname]}")
    log({"phase": "train-parity", "model": label, "dtype": "float32",
         "iters": 2, "grad_max_abs_err": grad_err,
         "grad_rel_l2_err": grad_rel, "grad_rtol": GRAD_RTOL,
         **report, "sign_flip_lr": SIGN_FLIP_LR,
         "update_rtol": UPDATE_RTOL, "moment_rtol": MOMENT_RTOL,
         "noise_rel": NOISE_REL, "controls_passing_leaves": controls,
         "ok": not (bad or state_bad)})
    if bad or state_bad:
        fail(f"{label}: training on the card differs from the CPU at "
             f"{bad + state_bad}")


def _to_cpu_state(st):
    import copy
    out = copy.copy(st)
    out.params = {n: p.cpu() for n, p in st.params.items()}
    for f in ("gen_opt", "disc_opt"):
        setattr(out, f, {s: ({n: t.cpu() for n, t in v.items()}
                             if isinstance(v, dict) else v)
                         for s, v in getattr(st, f).items()})
    return out


def _state_misses(ref, got, init, model, k):
    """Leaves where the state ``got`` departs from ``ref`` after 2
    iterations (see SIGN_FLIP_LR .. NOISE_REL), and the measures per
    leaf."""
    import torch
    bad = []
    lrs = [spec.lr for spec in model.opt_specs()]
    rep = {"param_max_abs_err": {}, "update_rel_err": {},
           "moment_max_abs_err": {}, "moment_err_of_max": {},
           "ratio_held_leaves": []}
    for (field, names), lr in zip((("gen_opt", model.GEN_PLAYER),
                                   ("disc_opt", model.DISC_PLAYER)), lrs):
        rm, gm = getattr(ref, field), getattr(got, field)
        leaves = [n for n in ref.params if n.split(".")[0] in names]
        top = max(float(rm["m"][n].abs().max()) for n in leaves)
        updates = 2 * k if field == "disc_opt" else 1
        for n in leaves:
            noise = float(rm["m"][n].abs().max()) <= NOISE_REL * top
            p_ref, p_got = ref.params[n], got.params[n]
            e = float((p_got - p_ref).abs().max())
            rep["param_max_abs_err"][n] = e
            if not e <= SIGN_FLIP_LR * lr * updates:
                bad.append(f"{n} param")
            for slot in ("m", "v"):
                want = rm[slot][n]
                em = float((gm[slot][n] - want).abs().max())
                top_n = float(want.abs().max())
                rep["moment_max_abs_err"][f"{field}|{slot}|{n}"] = em
                rep["moment_err_of_max"][f"{field}|{slot}|{n}"] = \
                    em / top_n if top_n else 0.0
                floor = 1e-7 if slot == "m" else 1e-14
                if noise:
                    floor = max(floor, NOISE_FLOOR * top if slot == "m"
                                else (NOISE_FLOOR * top) ** 2)
                if not em <= MOMENT_RTOL * top_n + floor:
                    bad.append(f"{n} {slot}")
            if noise:
                continue  # a gradient of rounding noise only
            moved = torch.linalg.vector_norm(p_ref - init[n])
            r = float(torch.linalg.vector_norm(p_got - p_ref) / moved)
            rep["update_rel_err"][n] = r
            rep["ratio_held_leaves"].append(n)
            if not r <= UPDATE_RTOL:
                bad.append(f"{n} update")
    return bad, rep


def phase_train_repeat(data):
    """Two runs from one seed give the same bits, and a run resumed from its
    checkpoint gives the bits of an uninterrupted one, per compute dtype."""
    import torch
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_repeat")
    shutil.rmtree(base, ignore_errors=True)
    for dtype in ("float32", "bfloat16"):
        model = _published(dtype)

        def trainer(name):
            return Trainer(model, data, os.path.join(base, dtype, name),
                           seed=7, device="cuda", checkpoint_every=0)

        a, b, c = trainer("a"), trainer("b"), trainer("c")
        a.train(REPEAT_ITERS)
        b.train(REPEAT_ITERS)
        c.train(REPEAT_ITERS // 2)
        resumed = trainer("c")
        resumed.train(REPEAT_ITERS)
        same = all(torch.equal(a.state.params[n], b.state.params[n])
                   for n in a.state.params)
        same_resumed = resumed._start_iter == REPEAT_ITERS // 2 and all(
            torch.equal(a.state.params[n], resumed.state.params[n])
            for n in a.state.params)
        log({"phase": "train-repeat", "dtype": dtype,
             "iters": REPEAT_ITERS, "two_runs_bit_identical": same,
             "resumed_at": resumed._start_iter,
             "resumed_bit_identical": same_resumed})
        if not (same and same_resumed):
            fail(f"train {dtype}: runs from one seed differ "
                 f"(two runs {same}, resumed {same_resumed})")


# ---------------------------------------------------------------------------
# K3's own path and the rest of family 1

def phase_bench_conv(launch_totals):
    """K3's path: the port's ``tools/bench_conv_kernel.main()`` at its four
    bf16 shapes, counts set to 0 before and read after."""
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.tools import bench_conv_kernel
    kernels.reset_launches()
    recs = bench_conv_kernel.main([])
    launch_totals.update(kernels.launches())
    for rec in recs:
        log({"bench_conv": rec})
    if len(recs) != len(bench_conv_kernel.SHAPES):
        fail(f"bench-conv printed {len(recs)} records")
    bad = [(r["shape"], arm) for r in recs for arm in bench_conv_kernel.ARMS
           if not (r[f"{arm}_rel_maxerr"] < 2e-2 and r[f"{arm}_us"] > 0)]
    if bad:
        fail(f"bench-conv: arms off the reference or not timed: {bad}")
    # the bench's bf16 shapes route K3a to its TMA mainloop, whose launches
    # are conv_gemm_taps's; K3b runs K1's kernels but not K1's counter
    not_tma = [r["shape"] for r in recs if r["k3_taps_route"]["path"] != "tma"]
    if not_tma:
        fail(f"bench-conv: K3a did not run its TMA mainloop at {not_tma}")
    if launch_totals.get("fused_conv2d_bias_act"):
        fail(f"bench-conv: K1's counter counted "
             f"{launch_totals['fused_conv2d_bias_act']} of K3's calls")


FAMILY1_ITERS = 3
# runs whose steady state is timed (FAMILY1_TIME_ITERS iterations) and
# profiled (PROFILE_ITERS) after their FAMILY1_ITERS
FAMILY1_PROFILED = (("mnist", "ali"), ("mnist", "wali-gp"),
                    ("celeba", "ali"))
FAMILY1_TIME_ITERS = 10


def _family1_model(dataset, mode):
    """The published config (core/config.py): mnist B=50, DIM=64, z=128,
    or z=8 with BN off for the vegan code/KL modes; celeba B=128, dim 32."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    cfg = gan_inference_defaults(dataset, mode)
    want = (50, 64) if dataset == "mnist" else (128, 32)
    if (cfg.batch_size, cfg.dim_g or cfg.dim) != want:
        fail(f"{dataset} {mode} defaults changed: {cfg}")
    return GanInferenceModel(cfg)


def _expected_kernels(cfg):
    """The kernels a Trainer run of ``cfg`` must launch (iteration 0 skips
    the G update; iterations 1-2 run it): K1 for every E (and xz-D) conv,
    K2a, K2b and K2c+K2d wherever BN is on."""
    names = ["fused_conv2d_bias_act"]
    if cfg.bn:
        names += ["bn_stats", "bn_apply", "bn_bwd"]
    return names


def phase_family1(launch_totals):
    """3 Trainer iterations of each of the 13 modes on mnist and of celeba
    ali, at published widths, on resident synthetic data; finite costs and
    parameters, and each mode's kernels launched. Then the mnist wali-gp
    penalty: K2c+K2d launches inside its create-graph backward (D's BN2 and
    BN3), and the penalty differentiates once more."""
    import torch
    from graphical_gan_tpu_torch.core.config import GAN_INFERENCE_MODES
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.runs.gan_inference import (
        _loaders, resident_data)
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_family1")
    shutil.rmtree(base, ignore_errors=True)
    runs = [("mnist", m) for m in GAN_INFERENCE_MODES] + [("celeba", "ali")]
    data = {}
    for dataset, mode in runs:
        model = _family1_model(dataset, mode)
        cfg = model.cfg
        if dataset not in data:
            # run()'s path: the loader's train factory, one epoch
            data[dataset] = resident_data(cfg, None, _loaders(cfg, None)[0])
        tr = Trainer(model, data[dataset],
                     os.path.join(base, f"{dataset}_{mode}"), seed=0,
                     device="cuda", checkpoint_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        metrics = tr.train(FAMILY1_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernels.launches()
        for k, v in got.items():
            launch_totals[k] = launch_totals.get(k, 0) + v
        missing = [k for k in _expected_kernels(cfg) if not got[k]]
        row = {"phase": "family1", "dataset": dataset, "mode": mode,
               "batch": cfg.batch_size, "dim": cfg.dim_g or cfg.dim,
               "z": cfg.dim_latent, "bn": cfg.bn, "k": cfg.critic_iters,
               "iters": FAMILY1_ITERS, "seconds": round(secs, 3),
               "last_metrics": metrics, "launches": got}
        if (dataset, mode) in FAMILY1_PROFILED:
            ms = _time_train(tr, FAMILY1_TIME_ITERS)
            busy, dev_ms, groups, top, host_ops, _ = _profile_train(
                tr, PROFILE_ITERS)
            images = (1 + cfg.critic_iters) * cfg.batch_size
            row.update(ms_per_iter=ms, images_per_s=images / ms * 1e3,
                       busy_share=busy, device_ms_per_iter=dev_ms,
                       device_ms_per_iter_by_group=groups,
                       top_kernels_ms_per_iter=top,
                       profiled_host_aten_ops_per_iter=host_ops)
        log(row)
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"family1 {dataset} {mode}: costs {metrics}")
        _finite_state(tr, f"family1 {dataset} {mode}")
        if missing:
            fail(f"family1 {dataset} {mode}: kernels never launched "
                 f"{missing}")
    _penalty_launches()


def _penalty_launches():
    """mnist wali-gp at published width: the penalty's create-graph
    backward launches K2c+K2d once per BN of D (BN2, BN3), and the
    penalty differentiates w.r.t. D's parameters with finite results."""
    import torch
    from graphical_gan_tpu_torch.core.registry import partition
    from graphical_gan_tpu_torch.ops import kernels
    model = _family1_model("mnist", "wali-gp")
    raw, noise = _parity_inputs(model, seed=5)
    params = model.init(seed=2, device="cuda")
    disc, _ = partition(params, model.DISC_PLAYER)
    leaves = {n: p.clone().requires_grad_(True) for n, p in disc.items()}
    merged = dict(params, **leaves)
    t = model._graph(merged, raw[0, 1].cuda(), p_z=noise["p_z"][0, 1].cuda(),
                     players_grad=False)
    kernels.reset_launches()
    gp = model.gradient_penalty(merged, t, noise["alpha"][0, 0].cuda())
    inside = kernels.launches()
    grads = torch.autograd.grad(gp, list(leaves.values()), allow_unused=True)
    finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    log({"phase": "family1-penalty", "model": "mnist wali-gp",
         "gp": float(gp), "launches_inside_penalty": inside,
         "second_order_grads_finite": finite})
    # D's BN2 and BN3: one K2c+K2d launch each in the create-graph backward
    if not (inside["bn_bwd"] == 2 and finite):
        fail(f"mnist wali-gp penalty: K2c+K2d launches {inside}, "
             f"finite second order {finite}")


def phase_family1_parity():
    """mnist ali and mnist wali-gp (at MNIST_PARITY_K): 2 iterations on the
    card against the CPU, the controls refused; and one mnist
    reconstructor dispatch."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import GanInferenceModel
    _train_parity(_family1_model("mnist", "ali"), "mnist ali", seed=4)
    model = GanInferenceModel(gan_inference_defaults(
        "mnist", "wali-gp", critic_iters=MNIST_PARITY_K))
    _train_parity(model, f"mnist wali-gp k={MNIST_PARITY_K}", seed=4)
    _mnist_dispatch_parity()


def _mnist_dispatch_parity():
    """One 50-row mnist ali reconstructor dispatch on the card against the
    same model on the CPU, through the server's entry, and its launches."""
    import numpy as np
    from graphical_gan_tpu_torch.core.config import asdict
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    model = _family1_model("mnist", "ali")
    run_dir = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                           "smoke_mnist_run")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(asdict(model.cfg), f, default=str)
    save_params(os.path.join(run_dir, "ckpt_0.npz"),
                model.init(seed=0, device="cuda"), {"iteration": 0})
    raw = np.random.default_rng(6).random((50, 784), dtype=np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        call, _, _, _ = sampler_from_run_dir(run_dir, entry="reconstructor",
                                             device=dev)
        kernels.reset_launches()
        outs[dev] = call(9, raw)
        got = kernels.launches()
    e = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    want = {"fused_conv2d_bias_act": 3, "bn_stats": 5, "bn_apply": 5}
    log({"phase": "family1-dispatch", "model": "mnist ali",
         "entry": "reconstructor", "B": 50, "gpu_vs_cpu_max_abs_err": e,
         "atol": E2E_ATOL, "launches": got})
    if not (e <= E2E_ATOL and np.isfinite(outs["cuda"]).all()
            and outs["cuda"].min() >= 0.0 and outs["cuda"].max() <= 1.0):
        fail(f"mnist reconstructor on the card differs from the CPU by {e}")
    if any(got[k] != v for k, v in want.items()):
        fail(f"mnist reconstructor launches {got}, want {want}")


# ---------------------------------------------------------------------------
# the dataset loaders, the eval hooks and the learning check

LOADER_ROWS = 640   # rows per CIFAR-10 pickle batch the loaders phase writes
LOADER_ITERS = 3


def write_cifar10_batches(data_dir: str):
    """Five ``data_batch_*`` pickles and a ``test_batch`` in CIFAR-10's
    format (a dict of uint8 ``data`` [N, 3072] and a ``labels`` list) from
    the structured family; returns the train rows [5 * LOADER_ROWS,
    3072]."""
    import pickle
    import numpy as np
    from graphical_gan_tpu_torch.data.synthetic import (
        structured_images_labeled)
    flat, y = structured_images_labeled(6 * LOADER_ROWS, (32, 32), 3, 10,
                                        seed=3)
    flat = flat.astype(np.uint8)
    os.makedirs(data_dir, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for i, name in enumerate(names):
        sl = slice(i * LOADER_ROWS, (i + 1) * LOADER_ROWS)
        with open(os.path.join(data_dir, name), "wb") as f:
            pickle.dump({"data": flat[sl], "labels": y[sl].tolist()}, f,
                        protocol=2)
    return flat[:5 * LOADER_ROWS]


def _rows(a):
    import numpy as np
    return sorted(bytes(r) for r in np.ascontiguousarray(a))


def _path_launches(fn, *args, **kwargs):
    """(fn's result, the kernels' launches in it: counts set to 0 just
    before and read just after)."""
    from graphical_gan_tpu_torch.ops import kernels
    kernels.reset_launches()
    out = fn(*args, **kwargs)
    return out, kernels.launches()


def _add(totals, got):
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v


def phase_loaders(launch_totals):
    """cifar10 wali-gp at the published config (B=64, DIM=64, k=5) for 3
    iterations through ``runs/gan_inference.run(data_dir=...)`` on CIFAR-10
    pickle batches written here: resident (the pool must hold the written
    train rows) and host-fed (each iteration's batches through the
    prefetcher's side stream); finite costs, the training kernels
    launched."""
    import numpy as np
    from graphical_gan_tpu_torch.data import prefetch
    from graphical_gan_tpu_torch.runs.gan_inference import run
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_loaders")
    shutil.rmtree(base, ignore_errors=True)
    data_dir = os.path.join(base, "cifar-10-batches-py")
    train_rows = write_cifar10_batches(data_dir)
    rows = {}
    for pipeline in ("resident", "host"):
        prefetch.side_stream_batches = 0
        (tr, metrics), got = _path_launches(
            run, "cifar10", "wali-gp", iters=LOADER_ITERS,
            data_dir=data_dir, outdir=os.path.join(base, pipeline),
            data_pipeline=pipeline, checkpoint_every=0, device="cuda")
        _add(launch_totals, got)
        row = {"phase": "loaders", "pipeline": pipeline,
               "iters": LOADER_ITERS, "last_metrics": metrics,
               "launches": got,
               "side_stream_batches": prefetch.side_stream_batches}
        if pipeline == "resident":
            pool = tr.data.cpu().numpy()
            row["pool_rows"] = int(pool.shape[0])
            row["pool_is_the_written_rows"] = (
                pool.dtype == np.uint8 and _rows(pool) == _rows(train_rows))
            if not row["pool_is_the_written_rows"]:
                fail("loaders: the resident pool is not the written "
                     "CIFAR-10 train rows")
        elif prefetch.side_stream_batches != LOADER_ITERS:
            fail(f"loaders: {prefetch.side_stream_batches} host batches came "
                 f"through the prefetcher's side stream, not {LOADER_ITERS}")
        log(row)
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"loaders {pipeline}: costs {metrics}")
        missing = [k for k in TRAIN_KERNELS if not got.get(k)]
        if missing:
            fail(f"loaders {pipeline}: kernels never launched {missing}")
        rows[pipeline] = row
    return rows


EVAL_ITERS = 100
EVAL_SAMPLE_EVERY = 50


def grid_misses(path: str, n: int, image_hw, channels: int):
    """What is wrong with a grid PNG of ``n`` images: its IHDR must give
    the size ``report/save_images.py``'s montage of n images makes, gray
    for one channel and RGB for three."""
    from graphical_gan_tpu_torch.report.save_images import (
        _grid_shape, png_size)
    if not os.path.isfile(path):
        return [f"{os.path.basename(path)} missing"]
    try:
        w, h, color = png_size(path)
    except ValueError as e:
        return [str(e)]
    nh, nw = _grid_shape(n, None)
    want = (nw * image_hw[1], nh * image_hw[0], 0 if channels == 1 else 2)
    if (w, h, color) != want:
        return [f"{os.path.basename(path)}: (width, height, color) "
                f"{(w, h, color)}, not {want}"]
    return []


def _log_values(text: str, name: str):
    """{iteration: value} of ``name`` in a trainer's logfile lines."""
    out = {}
    for line in text.splitlines():
        parts = line.split("\t")
        if not parts[0].startswith("iter ") or name not in parts:
            continue
        i = parts.index(name)
        out[int(parts[0][5:])] = float(parts[i + 1])
    return out


def eval_log_misses(text: str, last_iter: int):
    """What is missing from an eval run's logfile: a finite dev cost at
    ``last_iter``, and finite ``fid``, ``inception score`` and ``metric
    classifier heldout acc`` values; and no TSNE line (its cadence is
    50,000)."""
    misses = []
    dev = {**_log_values(text, "dev gen cost"),
           **_log_values(text, "dev rec cost")}
    if not (last_iter in dev and math.isfinite(dev[last_iter])):
        misses.append(f"no finite dev cost at iteration {last_iter}")
    for name in ("fid", "inception score", "metric classifier heldout acc"):
        vals = list(_log_values(text, name).values())
        if not vals or not all(math.isfinite(v) for v in vals):
            misses.append(f"no finite {name!r} line")
    if "tsne" in text:
        misses.append("a tsne line before its 50,000-iteration cadence")
    return misses


def phase_eval(launch_totals):
    """cifar10 wali-gp at the published config in bf16 on the structured
    family, 100 iterations through ``run()`` with the sample grids every
    50 and the quality hook at 100 (its classifier trained at the first
    firing, 10,000 samples scored): the four grid PNGs at their sizes, the
    dev cost at iteration 99, finite IS / FID / classifier accuracy lines,
    no TSNE (and sklearn not imported), the training kernels launched."""
    from graphical_gan_tpu_torch.runs.gan_inference import run
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_eval")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    (tr, metrics), got = _path_launches(
        run, "cifar10", "wali-gp", iters=EVAL_ITERS, data_dir="structured",
        compute_dtype="bfloat16", outdir=base,
        sample_every=EVAL_SAMPLE_EVERY, inception_every=EVAL_ITERS,
        checkpoint_every=0, device="cuda")
    _add(launch_totals, got)
    cfg = tr.cfg
    hw, c = cfg.data.image_hw, cfg.data.channels
    misses = []
    for it in range(EVAL_SAMPLE_EVERY - 1, EVAL_ITERS, EVAL_SAMPLE_EVERY):
        stem = os.path.join(tr.outf, f"{cfg.mode}_{cfg.dataset}_")
        misses += grid_misses(f"{stem}samples_{it}.png", cfg.n_vis, hw, c)
        misses += grid_misses(f"{stem}reconstruction_{it}.png",
                              2 * cfg.batch_size, hw, c)
    with open(tr.logfile) as f:
        text = f.read()
    misses += eval_log_misses(text, EVAL_ITERS - 1)
    if "sklearn" in sys.modules:
        misses.append("sklearn was imported")
    missing = [k for k in TRAIN_KERNELS if not got.get(k)]
    if missing:
        misses.append(f"kernels never launched {missing}")
    log({"phase": "eval", "iters": EVAL_ITERS, "dtype": cfg.compute_dtype,
         "seconds": round(time.perf_counter() - t0, 3),
         "pngs": sorted(f for f in os.listdir(tr.outf) if f.endswith(".png")),
         "quality": {name: _log_values(text, name) for name in (
             "dev gen cost", "inception score", "fid",
             "metric classifier heldout acc")},
         "last_metrics": metrics, "launches": got, "misses": misses})
    if misses:
        fail(f"eval: {misses}")


LEARN_ARGS = ["--checkpoints", "0,500", "--n-score", "5000"]
# the learning check's bounds: the instrument separates its anchors, and
# 500 iterations move IS up and FID down (BASELINE.md's JAX curve: IS 1.24
# -> 1.99, FID 43.2 -> 33.0 from iteration 0 to 500; anchors 9.90 / 1.26)
LEARN_MIN_ACC = 0.95
LEARN_MIN_REAL_IS = 8.0
LEARN_MAX_NOISE_IS = 2.0


def learn_misses(doc) -> list:
    """Which of the learning check's bounds a ``tools/sensitivity.py``
    document breaks: held-out accuracy, the real-data anchor's IS, the
    noise anchor's IS, and IS rising and FID falling from the ladder's
    first point to its last."""
    misses = []
    acc = doc["classifier_heldout_accuracy"]
    if not acc >= LEARN_MIN_ACC:
        misses.append(f"classifier held-out accuracy {acc} < {LEARN_MIN_ACC}")
    real = doc["anchors"]["heldout_real"]["is_mean"]
    if not real >= LEARN_MIN_REAL_IS:
        misses.append(f"held-out real IS {real} < {LEARN_MIN_REAL_IS}")
    noise = doc["anchors"]["uniform_noise"]["is_mean"]
    if not noise <= LEARN_MAX_NOISE_IS:
        misses.append(f"uniform-noise IS {noise} > {LEARN_MAX_NOISE_IS}")
    curve = sorted(doc["curve"], key=lambda e: e["iter"])
    if len(curve) < 2:
        return misses + [f"a curve of {len(curve)} points"]
    first, last = curve[0], curve[-1]
    if not last["is_mean"] > first["is_mean"]:
        misses.append(f"IS did not rise: {first['is_mean']} at "
                      f"{first['iter']}, {last['is_mean']} at {last['iter']}")
    if not last["fid"] < first["fid"]:
        misses.append(f"FID did not fall: {first['fid']} at {first['iter']}, "
                      f"{last['fid']} at {last['iter']}")
    return misses


def phase_learn(launch_totals):
    """``tools/sensitivity.py`` on the card (bf16, published width) with
    ``LEARN_ARGS``; the document is logged whole and held to
    ``learn_misses``."""
    from graphical_gan_tpu_torch.tools import sensitivity
    doc, got = _path_launches(sensitivity.main, LEARN_ARGS)
    _add(launch_totals, got)
    log({"learn": doc, "launches": got})
    misses = learn_misses(doc)
    missing = [k for k in TRAIN_KERNELS if not got.get(k)]
    if missing:
        misses.append(f"kernels never launched {missing}")
    if misses:
        fail(f"learn: {misses}")


SOURCES = {
    "fused_conv2d_bias_act": (
        "graphical_gan_tpu_torch/csrc/fused_conv.cu",
        "graphical_gan_tpu/ops/pallas/fused_conv.py:135"),
    "bn_stats": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                 "graphical_gan_tpu/ops/pallas/fused_norm.py:143"),
    "bn_apply": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                 "graphical_gan_tpu/ops/pallas/fused_norm.py:182"),
    # both pallas_calls of _bwd: the reduce (:212) and the apply (:223)
    "bn_bwd": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
               "graphical_gan_tpu/ops/pallas/fused_norm.py:212, "
               "graphical_gan_tpu/ops/pallas/fused_norm.py:223"),
    # K3a's bf16 mainloop at the bench shapes (other shapes route to K1's)
    "conv_gemm_taps": ("graphical_gan_tpu_torch/csrc/conv_gemm_tma.cu",
                       "graphical_gan_tpu/ops/pallas/conv_gemm.py:206"),
    # K3b runs K1's mainloops; bf16 at the bench shapes takes wgmma
    "conv_gemm_im2col": ("graphical_gan_tpu_torch/csrc/fused_conv_wgmma.cu",
                         "graphical_gan_tpu/ops/pallas/conv_gemm.py:186"),
}
SERVE_KERNELS = ("fused_conv2d_bias_act", "bn_stats", "bn_apply")
TRAIN_KERNELS = SERVE_KERNELS + ("bn_bwd",)
K3_KERNELS = ("conv_gemm_taps", "conv_gemm_im2col")


# K1's summary rows: (dtype, B, the run whose launches they count)
K1_ROWS = (("float32", 64, "train"), ("bfloat16", 64, "train"),
           ("float32", 256, "serve"), ("bfloat16", 256, "serve"))


def _k1_rows(timings, k1_counts):
    """K1 per dtype at the training batch (B=64) and the serving dispatch's
    (B=256): times summed over E.1-3 (the shapes of D.1-3 too), with the
    launches of that dtype's training run (TRAIN_ITERS iterations) or
    serving run."""
    out = []
    for dn, b, run in K1_ROWS:
        rows = [r for r in timings if r["kernel"] == "fused_conv2d_bias_act"
                and r["dtype"] == dn and r["B"] == b]
        ops_ms = sum(r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in rows
                       if r["bound_by"] == "bytes")
        out.append({
            "dtype": dn, "B": b, "launches": k1_counts[(dn, run)],
            "launches_of": run,
            **{k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "per_shape": [{k: r[k] for k in (
                "shape", "path", "tile", "splits", "ms", "library_ms",
                "bound_ms", "bound_by")} for r in rows]})
    return out


def _k3_rows(timings, name):
    """K3a's or K3b's rows per dtype over the four bench shapes, with each
    shape's route (path, tile, splits)."""
    out = []
    for dn in ("bfloat16", "float32"):
        rows = [r for r in timings if r["kernel"] == name
                and r["dtype"] == dn]
        ops_ms = sum(r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in rows
                       if r["bound_by"] == "bytes")
        out.append({
            "dtype": dn,
            **{k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "per_shape": [{k: r[k] for k in (
                "shape", "B", "path", "tile", "splits", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")} for r in rows]})
    return out


def _bn_rows(timings, name):
    """K2a's or K2c+K2d's rows per dtype and B over the 5 BN shapes, each
    shape with its units and times (K2c+K2d's also with whether its g and
    x stay in shared memory)."""
    keys = ("shape", "units", "ms", "plain_ms", "library_ms", "bound_ms")
    if name == "bn_bwd":
        keys += ("onchip",)
    out = []
    for dn in ("float32", "bfloat16"):
        for b in (64, 256):
            rows = [r for r in timings if r["kernel"] == name
                    and r["dtype"] == dn and r["B"] == b]
            out.append({
                "dtype": dn, "B": b,
                **{k: sum(r[k] for r in rows)
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "per_shape": [{k: r[k] for k in keys} for r in rows]})
    return out


def summary(errs, timings, launches):
    """One entry per kernel. The forward kernels' times are summed over the
    shapes of one reconstructor dispatch at B=256 in f32 (K1 adds ``rows``:
    f32 and bf16 at B=64 and 256; K2a too, per shape with its units);
    K2c+K2d's over the 5 BN shapes one training iteration
    backpropagates through at B=64 in f32 (it adds ``rows`` as K2a, with
    each shape's on-chip case); K3's over the four bench shapes
    in bf16 (K3 adds ``rows``: bf16 and f32, per shape with its route).
    ``launches`` counts each kernel's main path (the cifar10
    training runs; for K3 the bench-conv run), ``launches_serve`` the
    serving run, ``launches_family1`` the family1 runs and
    ``launches_loaders`` / ``_eval`` / ``_learn`` those phases' runs."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        k3 = name in K3_KERNELS
        backward = name not in SERVE_KERNELS and not k3
        b = 64 if backward else 256
        rows = [r for r in timings if r["kernel"] == name and (
            r["dtype"] == "bfloat16" if k3
            else r["B"] == b and r["dtype"] == "float32")]

        def total(key):
            return sum(r[key] for r in rows)
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        if k3:
            over = "the 4 bench shapes (disc2, disc3 at B=64 and 512), bf16"
        elif backward:
            over = ("one training iteration's 5 BN shapes, B=64, f32 "
                    "(library: one call for K2c+K2d)")
        else:
            over = "one reconstructor dispatch, B=256, f32"
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": launches["bench" if k3 else "train"][name],
                    "launches_serve": launches["serve"][name],
                    "launches_family1": launches["family1"][name],
                    **{f"launches_{path}": launches[path].get(name, 0)
                       for path in ("loaders", "eval", "learn")},
                    "max_abs_err": errs[name],
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"),
                    "bound_by": ("operations" if ops_ms >= bytes_ms
                                 else "bytes"),
                    "library_ms": total("library_ms"),
                    "summed_over": over})
        if name == "fused_conv2d_bias_act":
            out[-1]["rows"] = _k1_rows(timings, launches["k1"])
        if k3:
            out[-1]["rows"] = _k3_rows(timings, name)
        if name == "bn_stats":
            out[-1]["rows"] = _bn_rows(timings, name)
        if name == "bn_bwd":  # max_abs_err is dx's; red sums R terms
            out[-1]["red_max_abs_err"] = errs["bn_bwd_red"]
            out[-1]["rows"] = _bn_rows(timings, name)
    return {"kernels": out}


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log({"phase_seconds": name, "seconds": round(time.perf_counter() - t0,
                                                 3)})
    return out


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
        import numpy as np
        from graphical_gan_tpu_torch.core.device import set_numerics
        from graphical_gan_tpu_torch.data.synthetic import images_int
        card = phase_device()
        # the port's numerics for the kernels, the plain versions and the
        # library calls alike: no TF32 (cuDNN's default for f32
        # convolutions), deterministic cuDNN
        set_numerics()
        errs, timings = {}, []
        launches = {"serve": {}, "train": {}, "bench": {}, "family1": {},
                    "loaders": {}, "eval": {}, "learn": {}, "k1": {}}
        _timed("build", phase_build)
        _timed("check", phase_check, errs)
        _timed("time", phase_time, timings)
        run_dirs = _timed("serve", phase_serve, launches["serve"],
                          launches["k1"])
        missing = [k for k in SERVE_KERNELS if not launches["serve"].get(k)]
        if missing:
            fail(f"kernels never launched on the serving path: {missing}")
        _timed("dispatch", phase_dispatch, run_dirs)
        data = images_int(50_000, 3072, seed=0).astype(np.uint8)
        _timed("train", phase_train, launches["train"], data,
               launches["k1"])
        missing = [k for k in TRAIN_KERNELS if not launches["train"].get(k)]
        if missing:
            fail(f"kernels never launched on the training path: {missing}")
        _timed("train-parity", phase_train_parity)
        _timed("train-repeat", phase_train_repeat, data)
        _timed("bench-conv", phase_bench_conv, launches["bench"])
        missing = [k for k in K3_KERNELS if not launches["bench"].get(k)]
        if missing:
            fail(f"kernels never launched on the bench-conv path: {missing}")
        _timed("family1", phase_family1, launches["family1"])
        _timed("family1-parity", phase_family1_parity)
        _timed("loaders", phase_loaders, launches["loaders"])
        _timed("eval", phase_eval, launches["eval"])
        _timed("learn", phase_learn, launches["learn"])
        if "jax" in sys.modules or "graphical_gan_tpu" in sys.modules:
            fail("JAX or the JAX package was imported")
        imported = [m for m in ("PIL", "matplotlib", "sklearn")
                    if m in sys.modules]
        if imported:
            fail(f"imported {imported}, which the card's machine lacks")
        log(summary(errs, timings, launches))
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
