#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX or of the JAX package, and does in order:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles ``graphical_gan_tpu_torch/csrc/*.cu`` with nvcc and
   requires ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA load) instructions
   in the library's SASS, ``IMMA`` (Q2's ``mma`` route), and ``IGMMA``
   (int8 ``wgmma``) with ``UTMALDG`` in Q2's ``tma`` kernel;
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
   K1 and K2 at the shapes family 2 and the step options add
   (``family2_batches``: G's BNs at the per-component grid's 300 rows, E,
   D and the BNs at the microbatches 25 and 32 of ``accum_steps=2``,
   GMGAN's D trunk with the leaky ReLU in K1's epilogue, E at the accuracy
   hook's and the cluster entry's batches, the fused penalty's D at 192);
4. time: per kernel and shape, the kernel's median time from CUDA events
   on inputs that are not in L2 (``tools/timing.py``), its plain
   version's, one PyTorch library call's, and the bound (bytes over the
   card's HBM rate or the operations the function needs, taps in the
   padding left out, over its peak for the dtype: ``tools/mfu.py``'s
   ``PEAK`` and ``PEAK_BW`` by the card's name); K3 in f32 and bf16
   at the bench shapes, with each variant's route;
5. serve: writes a full-width cifar10 wali-gp run directory (random
   weights from a seed), serves the sampler, encoder and reconstructor
   entries over HTTP on localhost through the port's server, checks the
   outputs and that every dispatch went through the kernels, and compares a
   64-row reconstruction with the same model on the CPU;
6. dispatch: per dtype, entry and bucket, a dispatch's host and device
   time, its device busy share, its device time and kernels by group (no
   more than one K2a kernel per BN forward);
7. int8-export: Q1 (quantize), Q2 (int8 conv, ``csrc/quant.cu``,
   ``csrc/quant_tma.cu``) and K2b with its int8 copy (``bn_apply_q8``) at
   every int8 layer of the published samplers (cifar10 wali-gp, GMGAN
   mnist, SSGAN moving-MNIST) at buckets 8, 64 and 256 in f32 and bf16,
   each call replayed twice against its plain version (int8 values and
   int32 sums equal, outputs bit-equal, one launch per call; each Q2 call
   logs ``q2_plan``'s route, tile and splits; the cifar10 sampler's bf16
   model on bf16 codes) and timed (Q2 at buckets 8 and 256, with
   ``torch._int_mm`` at the dense shapes; at the cifar10 shapes its
   ``mma`` route beside the planned one and cuDNN's f32 and bf16 conv as
   readings; K2b's int8 copy beside K2b alone); the three
   quantized samplers on the card against the CPU, on their first call
   and on a later one that takes the BNs' int8 copies (no int8 value
   flipped, outputs within 1e-6);
   a cifar10 dispatch int8 against float; the server with ``--quantize
   int8`` over HTTP, its launches counted; then the run directory
   exported with ``torch.export`` (the int8 sampler, the float
   reconstructor) and served from the artifacts in a fresh process
   through ``--export-dir``'s path, bit for bit against the run
   directory, Q1, Q2, K1 and K2 launched inside the programs;
8. train: the port's Trainer at the published cifar10 wali-gp config
   (B=64, DIM=64, z=128, k=5) on a resident synthetic 50k set, in f32 and
   bf16, on its step graph (iterations 0-1 eager, the capture at 2, then
   replays), under ``torch.profiler``: finite costs, every kernel
   launched; the training kernels' executions read off the device trace
   (a replay calls no wrapper) exactly PER_ITER's, the wrappers' counts
   PER_ITER's for the iterations that ran Python (the eager ones and the
   capture); then on the graph ms per iteration, images/s, busy share and
   device time by group (a replayed kernel in the group its eager
   launches had in the main path's trace); then 2 iterations on the card
   against the CPU from the same params, batches and noise, two runs from
   one seed bit for bit, and a resumed run against an uninterrupted one;
   in f32 the eager dispatch's host ms/iter and host ops with the kernels
   called straight (as eager calls run) and through their
   ``torch.library`` ops' dispatcher (as traced calls run; a reading);
9. bench-conv: K3's own path, ``tools/bench_conv_kernel.main()`` (four
   bf16 shapes, the library arm beside K3a and K3b; ``--reps 0 --rounds 5
   --n-inputs 4``); K3a must run its TMA mainloop there, and K1's counter
   must not count K3's calls;
10. family1: 3 Trainer iterations of each of the 13 modes on mnist (B=50,
   DIM=64) and of celeba ali (B=128, dim 32) at published widths on
   resident synthetic data: finite costs, each mode's kernels launched,
   K2c+K2d inside the mnist wali-gp penalty's backward; then mnist ali and
   wali-gp (k = 2) 2 iterations on the card against the CPU (the same
   checks and controls as train-parity) and one mnist reconstructor
   dispatch;
11. loaders: cifar10 wali-gp at the published config, 3 iterations
   through ``runs/gan_inference.run`` on CIFAR-10 pickle batches written
   here, resident (the pool is the written train rows) and host-fed (every
   batch through the prefetcher's side stream);
12. eval: 100 iterations of cifar10 wali-gp in bf16 on the structured
   family with the sample grids every 50 and the quality hook at 100: the
   grid PNGs at their sizes (read from their IHDR), the dev cost at
   iteration 99, finite IS / FID / classifier accuracy, no TSNE line;
13. learn: ``tools/sensitivity.py --checkpoints 0,500 --n-score 5000``
   (bf16, published width): classifier held-out accuracy >= 0.95, real IS
   >= 8.0, noise IS <= 2.0, IS up and FID down from iteration 0 to 500;
   and PIL, matplotlib and sklearn never imported;
14. step-options: cifar10 wali-gp (B=64, k=5) 2 iterations on the card
   against the CPU with ``accum_steps=2``, with ``remat`` and with
   ``fused_gp`` (train-parity's checks and controls); remat on the card
   bit-identical to no remat; a celeba ali run with ``decay`` whose Adam
   step sizes are logged and held to the undecayed ones times
   1 - t / iters;
15. family2: 3 Trainer iterations of GMGAN's 5 modes under each of the 4
   MODE_K on mnist (B=50, DIM=64, z=128, 30 components), and of cifar10
   and svhn local_ep and celeba ali, at published widths: finite costs,
   K1 launched, K2a-d where BN is on; mnist local_ep CONCRETE then timed
   and profiled as the family1 runs are;
16. family2-parity: mnist local_ep CONCRETE and ali REINFORCE, 2
   iterations on the card against the CPU, the controls refused, q(k|x)'s
   argmax flips between the devices logged with their margins;
17. cluster: a gmgan mnist run directory served over HTTP, the sampler
   from server-drawn one-hot and normal priors and the cluster entry,
   whose rows sum to 1 within 1e-5 and equal the CPU's within 1e-4;
18. family2-learn: ``runs/gmgan.run("mnist", "local_ep",
   data_dir="structured")`` for 1,000 iterations, its clustering accuracy
   held to ``LEARN2_MIN_ACC``;
19. family3: 3 Trainer iterations of SSGAN at published widths (B 50,
   DIM 32): moving-MNIST (LEN 16) local_ep under each pos_mode,
   local_epce-z, ali under concat_x, concat_z and 3dcnn, alice-z, chairs
   (LEN 31) local_ep, and local_ep with ``bn=True`` through ``run()``:
   finite costs, K1 launched (K2a-d with BN); local_ep timed and profiled;
   the check and time phases hold K1 at family 3's shapes (the frame
   batch B·LEN, Cin 1/3, the whole video as C·LEN channels, the VALID
   D.5) and K2 at its BN shapes (``family3_batches``, ``ssgan_*_shapes``);
20. family3-parity: moving-MNIST local_ep gsp and ali 3dcnn, 2
   iterations on the card against the CPU at FAMILY3_PARITY_BATCH videos
   (a G bias moment that misses is held again from the card's own state
   only where its gradient is shown to cancel, ``_bias_cancellation``);
21. family3-serve: a moving-MNIST run directory over HTTP, the sampler
   from server-drawn priors and the reconstructor, held to the CPU within
   E2E_ATOL;
22. family3-learn: ``runs/ssgan.run("moving_mnist", "local_ep",
   data_dir="structured", data_pipeline="device",
   compute_dtype="bfloat16")`` for 1,000 iterations, the hook before
   training and at 500 and 1,000: the reading at 1,000 at most half the
   one before training, every montage at its size;
23. tools: each measurement tool of ``graphical_gan_tpu_torch/tools`` at
   published widths: ``trace_report`` over the cifar10 wali-gp Trainer's
   ``GGAN_PROFILE`` trace (its device ms per iteration within
   TRACE_AGREE of ``profile_train``'s) and over SSGAN moving-MNIST
   local_ep f32's (its top kernels with the ops and shapes that launched
   them), each divided by the iterations the trace's name says it holds
   (the trace is aligned to the chunked loop's dispatches); ``mfu`` for
   gan f32 and bf16, gmgan and ssgan f32 (0 < mfu <= 1 and, from the
   byte count per iteration, 0 < hbm_bw_util <= 1); ``memory`` for gan
   f32 (the peak above the state and data, within the card's memory);
   ``determinism`` for gan (DIM 64, B 64) and gmgan
   mnist local_ep at its published width (all five checks bit-identical);
   ``bench_families``, ``bench_serving`` (three families, batches 8 and
   256) and ``bench_server`` (gan_inference, request sizes 1 and 8); then
   the GMGAN process replay: one Trainer run in a fresh subprocess and
   one here, and one more in a subprocess while another process holds
   most of the card's free memory, their final parameters compared bit
   for bit and printed as readings (ROADMAP §3 fault 1);
24. fault4: one published cifar10 wali-gp f32 step, plain, with
   ``remat`` and with ``fused_gp``: every ``convolution_backward`` inside
   the penalty's ``input_grads_only`` scope computes no weight gradient
   (the scope holds on the card, where autograd would otherwise run a
   node's backward on a device thread), and ``tools/mfu.py``'s FLOP
   count at that config;
25. phase-deconv: the phase route of ``ops/phase_deconv.py`` (one stride-1
   K1 conv to 4·O channels, then a depth-to-space) against the cuDNN route
   at the eight shapes of ``tools/bench_phase_deconv.py``, forward, dx and
   dw in f32 and bf16 at K1's tolerances, one K1 launch per call (the
   check phase holds K1 itself at those stride-1 shapes, their routes in
   the coverage check); the bench tool on the card, and with ``--k 3`` at
   two shapes; an SSGAN moving-MNIST f32 iteration and an f32 sampler
   dispatch at B 256 with
   ``GGAN_PHASE_DECONV`` off and on;
26. failure: the CLI at the published cifar10 wali-gp config in
   subprocesses: SIGTERM after iteration 4 (exit 0, resumed to 60 bit for
   bit against an uninterrupted run), ``GGAN_FAULT_NAN_AT=7`` with one
   rollback (finite, ``rng_salt_high`` 1) and without the guard (inert),
   async checkpoints equal to sync ones, ``--compile-cache`` built once and
   then loaded with no ``nvcc`` run; the time a save holds the loop;
27. frozen-inception: the complete Inception-v3 (2015 ``classify_image``)
   architecture written as a GraphDef by this script's protobuf writer
   (``inception_v3_2015_graphdef``: the op sequence and channel plan of
   tests/test_inception_full_graph.py, 94 convs, ~24M random weights from
   seed 0, ~95 MB of Consts), read by the port's reader into
   ``FrozenInceptionClassifier(device="cuda")``: finite probabilities
   that sum to 1, images/s at batch 100 of 32x32x3 images in [0, 255]
   (the graph resizes them to 299) from CUDA events against the f32 bound
   of the graph's Conv2D and head operations (``frozen_flops``); then
   ``default_is_classifier("cuda")`` with ``GGAN_INCEPTION_PB`` naming the
   file and ``tools/score_samples.py --classifier frozen`` on a
   full-width cifar10 wali-gp checkpoint, each reaching the frozen head on
   the card;
28. frozen-parity: pool_3 and the probabilities of 8 images on the card
   against the same graph on the CPU (relative L2 within 1e-4, TF32 off);
29. quality-run: ``tools/quality_run.py`` at the published cifar10
   wali-gp width, bf16 and f32, 100 iterations and 1,000 metric samples
   each: finite records with the JAX tool's keys, the training kernels
   launched (the check phase holds K1 and K2 at the shapes its width-64
   metric classifier and bf16 samples add, ``_check_quality_run``);
30. library-ops: each op no model uses (``batchnorm_moving_stats`` in both
   branches, ``layernorm``, ``cond_batchnorm``, ``minibatch_layer``,
   ``ladder``, weight-normed and orthogonal ``linear``, masked,
   weight-normed and bias-free ``conv2d`` on K1, ``conv1d``, VALID
   ``deconv2d`` at k 3-5 and stride 1-2, ``objectives/gan.py``,
   ``local_ep_dynamic``, the layout transposes) on the card against its
   CPU run, outputs and gradients; ``epoch_batches_ondevice`` on the card;
   K1's launches counted;
31. split-kernels: K2a's and K2c+K2d's split modes (batch statistics
   over the rows of several ranks: ``bn_stats_local``, one cluster launch
   into the rank's slot of the exchange buffer; ``bn_apply_split`` and
   ``bn_apply_split_q8``, K2b with the finalize folded in; ``bn_bwd_
   local``, one cluster launch of the rank's backward sums into its slot;
   ``bn_bwd_apply_split``, K2d with the ranks' sums added in rank order
   folded in) at the training BN shapes of B=64 over 2 and 4 ranks' rows,
   f32 and bf16: each kernel twice against its plain version, the other
   slots zero, the apply's y and int8 copy bit for bit the one-launch
   K2b's at its statistics, the chains against the one-process plain
   versions over the whole batch, and each timed at one rank's rows
   beside its plain version, its ``torch.batch_norm_*`` library call,
   the split forward and backward chains and the one-launch kernels over
   the whole batch;
32. int8-deconv: the int8 transposed conv of every stride and padding
   (``ops/quant.py: intercept_deconv2d``) at cifar10's G deconvs, on the
   card bit-equal to the CPU, its Q2 call against Q2's plain version, and
   timed on ``q2_plan``'s route;
33. parallel: ``tools/parallel_check.py``: dp, tp, sp, ep and composed at
   world size 1 over NCCL bit for bit against the one-device step, then
   dp, tp (cifar10 wali-gp), ep (GMGAN mnist local_ep) and sp (SSGAN
   moving-MNIST local_ep, BN on) on 2 gloo ranks on this card at the
   published widths against the one-device step, the replicas bit-identical;
   rank 0's launches are the split kernels' main path; tp's state saved
   through the sharded checkpoint backend and resumed, bit for bit with
   the uninterrupted run, in both; dp's ``Trainer`` on the 2 ranks at
   ``chunk_size`` 2 against 1, bit for bit; the pipeline on 2 gloo ranks
   (cifar10
   wali-gp, GMGAN mnist local_ep) and on 4 (the 4-stage cifar10 ali cut)
   at the published widths against the one-process staged step, each
   rank's launches (K1 on the ranks with convolutions, K2a/K2b/K2c+K2d on
   the ranks with E's and G's BNs, no split kernel), seconds and bubble
   share; standard -> pp -> standard and back bit for bit; the server's
   ``--dp-devices 2`` on 2 gloo ranks, a bucket-64 dispatch float and
   int8 against one rank's, the split forward launched (one
   ``bn_stats_local`` for each ``bn_apply_split`` or int8 form, no
   one-launch K2a or K2b);
34. chunk: the trainer's chunked resident loop (JAX's dispatches of up
   to ``chunk_size`` iterations between host events) and its step graph
   (``train/graph.py``: the iteration captured once as a CUDA graph and
   replayed): the published cifar10 wali-gp Trainer in f32 and bf16,
   the graph at chunk_size None and 1 against the eager dispatch
   (``Trainer._eager``) over 12 iterations with checkpoints at 7 and 11
   and a hook at 5 and 11, bit for bit (parameters, Adam's m, v and t,
   step, every logged cost, every checkpoint array), one capture per
   graph Trainer, the training kernels' executions read off each run's
   device trace exactly PER_ITER's and the wrappers' counts PER_ITER's
   for the iterations that ran Python; in f32 a resume at a
   window boundary under the graph against the eager run, and a rollback
   through ``GGAN_FAULT_NAN_AT`` inside a window, the graph (captured
   again after it) against the eager dispatch, bit for bit; GMGAN mnist
   local_ep, SSGAN moving-MNIST local_ep on the device pipeline's
   sampler and cifar10 wali-gp with remat, 9 iterations, the graph at
   chunk 3 against the eager dispatch at 1; then per dtype, on new warm
   Trainers, the warm host ms per iteration of one 30-iteration window,
   the graph at chunk_size None and 1, then eager at None, each one's
   busy share and device ms per iteration over 5, and the graph's
   captures and the memory reserved after its capture (a reading);
35. prints one JSON line per kernel summary, the card line, and last
   ``{"ok": true, "device": {...}}``.

The numbers name the phases; the run takes them in another order. First,
one at a time, the phases that time the card: 1-9 (but train-parity and
train-repeat; 31 and 32 right after 4, 34 right after 8), 10, 15, 19,
23, 25 and 27. Then
the side phases, failure (26), learn (13), family2-learn (18),
family3-learn (22), parallel (33) and eval (12), start, each in a process of its own (``SidePhases``: they are bound by the host, so
they overlap on a machine of several cores; failure's readings are so
taken beside the others), and beside them the rest run in this process:
28, 30, 29 (its throughput so read beside the side phases), train-parity,
train-repeat, the family1 parity checks, 11, 14, 16, 17, 20, 21 and
24. Last the side phases are joined, their output logged and their
launches counted.

Any failed check exits non-zero without the last line. ``--log PATH`` also
writes every logged line to PATH. Each phase logs its seconds.
"""

from __future__ import annotations

import argparse
import functools
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


@functools.cache
def card_peaks():
    """(peak operations/s by dtype, HBM bytes/s) of card 0, read from
    ``tools/mfu.py``'s tables (``PEAK``, ``PEAK_BW``) by the card's name;
    without a card (the CPU tests of the bounds' arithmetic) the H100's,
    the card this script checks."""
    import torch
    from graphical_gan_tpu_torch.tools import mfu
    return mfu.card_peaks(torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else mfu.H100)


def hbm_ms(nbytes: float) -> float:
    """ms to move ``nbytes`` at card 0's HBM rate."""
    return nbytes / card_peaks()[1] * 1e3


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / card_peaks()[0][dtype] * 1e3
    t_bytes = hbm_ms(nbytes)
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
    counts = _sass_count(path, ("HGMMA", "UTMALDG", "IMMA", "IGMMA"))
    hgmma, utmaldg, imma = counts[""][:3]
    q2_igmma, q2_utmaldg = counts[Q2_TMA_KERNEL][3], counts[Q2_TMA_KERNEL][1]
    log({"phase": "build", "seconds": round(secs, 3),
         "library": os.path.relpath(path, ROOT),
         "sources": [os.path.relpath(s, ROOT) for s in build.sources()],
         "sass_hgmma_instructions": hgmma,
         "sass_utmaldg_instructions": utmaldg,
         "sass_imma_instructions": imma,
         "sass_q2_tma_igmma_instructions": q2_igmma,
         "sass_q2_tma_utmaldg_instructions": q2_utmaldg})
    for ln in ptxas:
        log("ptxas: " + ln)
    if not hgmma:
        fail("no HGMMA instruction in the library's SASS: K1's bf16 path "
             "does not run on wgmma")
    if not utmaldg:
        fail("no UTMALDG instruction in the library's SASS: K3a's mainloop "
             "issues no TMA load")
    if not imma:
        fail("no IMMA instruction in the library's SASS: Q2's mma route "
             "does not run on the tensor cores")
    if not (q2_igmma and q2_utmaldg):
        fail(f"Q2's tma kernel has {q2_igmma} IGMMA (int8 wgmma) and "
             f"{q2_utmaldg} UTMALDG (TMA load) instructions in its SASS")


# the mangled name's part of Q2's tma kernel (csrc/quant_tma.cu)
Q2_TMA_KERNEL = "int8_conv_tma_kernel"


def _sass_count(lib_path: str, opcodes):
    """Instructions of each of ``opcodes`` in the SASS of ``lib_path`` (one
    ``cuobjdump -sass``, from the CUDA toolkit): under key "" in the whole
    library, under :data:`Q2_TMA_KERNEL` in the functions whose name holds
    it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    counts = {"": [0] * len(opcodes), Q2_TMA_KERNEL: [0] * len(opcodes)}
    in_q2 = False
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            in_q2 = Q2_TMA_KERNEL in ln
            continue
        for i, op in enumerate(opcodes):
            if op in ln:
                counts[""][i] += 1
                if in_q2:
                    counts[Q2_TMA_KERNEL][i] += 1
    return counts


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


def mnist_shapes(b: int):
    """(conv rows: name, x NHWC, Cout, act; BN rows: name, (R, C), act) of
    the mnist E (D.2/D.3 of family 1 too) and G at batch ``b``."""
    conv = [(n, (b,) + shape[1:], cout, act)
            for n, shape, cout, act in MNIST_CONV]
    bn = [(n, (rc[0] // 50 * b, rc[1]), act) for n, rc, act in MNIST_BN]
    return conv, bn


def d_trunk_shapes(b: int, hw: int, cin: int, dim: int = 64):
    """GMGAN's data-side D trunk (and family 1's cifar10/svhn D): three k5
    s2 convs with the leaky ReLU in K1's epilogue, no BN."""
    h2, h4 = -(-hw // 2), -(-hw // 4)
    tag = "mnist" if cin == 1 else "cifar10"
    return [(f"{tag} D.1 leaky", (b, hw, hw, cin), dim, "leaky_relu"),
            (f"{tag} D.2 leaky", (b, h2, h2, dim), 2 * dim, "leaky_relu"),
            (f"{tag} D.3 leaky", (b, h4, h4, 2 * dim), 4 * dim,
             "leaky_relu")]


def family2_batches() -> dict:
    """The batch sizes the new paths run K1 and K2 at, derived from the
    code's own constants: G's BNs at the per-component grid's rows
    (``runs/gmgan.py: grid_inputs``, mnist and cifar10, where G has BN);
    the microbatches of ``STEP_ACCUM`` at each published batch; E at the
    accuracy hook's test batches (the structured split over the batch
    size) and at the cluster phase's dispatches (the server's buckets);
    and the fused penalty's stacked D batch (3 B)."""
    from graphical_gan_tpu_torch.core.config import (
        gan_inference_defaults, gmgan_defaults)
    from graphical_gan_tpu_torch.runs import gmgan as gm
    cfgs = {ds: gmgan_defaults(ds) for ds in ("mnist", "cifar10")}
    cifar = gan_inference_defaults("cifar10", "wali-gp")
    n_eval = _default(gm._structured_loaders, "n_eval")
    return {
        "G_sample": {ds: sorted({len(gm.grid_inputs(c)[0])})
                     for ds, c in cfgs.items()},
        "micro": {"mnist": [cfgs["mnist"].batch_size // STEP_ACCUM],
                  "cifar10": sorted({cifar.batch_size // STEP_ACCUM,
                                     cfgs["cifar10"].batch_size
                                     // STEP_ACCUM})},
        "E": {"mnist": sorted(_batches_of(n_eval, cfgs["mnist"].batch_size)
                              | set(BUCKETS))},
        "fused": {"cifar10": [3 * cifar.batch_size]},
    }


def _check_family2(gen, errs, misses, seen):
    """K1 and K2 at the shapes family 2 and the step options add
    (``family2_batches``): G's BN forward at the grid's rows (f32, no
    gradient); E, D and the BNs with their backward at the microbatches;
    GMGAN's leaky D.1-3 at the published batches in both dtypes; E at the
    accuracy hook's and the cluster entry's batches; the fused penalty's
    D at 3 B (f32, its dtype in the step-options phase)."""
    import torch
    f32 = torch.float32
    batches = family2_batches()
    log({"check": "family2 batches", **batches})

    def convs(rows, dtype):
        for name, shape, cout, act in rows:
            x, w, bias = _conv_inputs(shape, cout, dtype, gen)
            _check_conv(f"{name} B={shape[0]}", x, w, bias, 2, "SAME", act,
                        errs, misses, seen)

    def bns(rows, dtype, backward):
        for name, rc, act in rows:
            x, scale, offset = _bn_inputs(rc, dtype, gen)
            _check_bn(f"{name} R={rc[0]}", x, scale, offset, act, 0.0, errs,
                      misses)
            for kind, g in _bn_cotangents(x, gen) if backward else ():
                _check_bn_bwd(f"{name}{kind} R={rc[0]}", x, g, scale, offset,
                              act, errs, misses)

    for b in batches["G_sample"]["mnist"]:
        bns([r for r in mnist_shapes(b)[1] if "G." in r[0]], f32, False)
    for b in batches["G_sample"]["cifar10"]:
        bns([r for r in bn_shapes(b) if r[0].startswith("G.")], f32, False)
    for b in batches["micro"]["mnist"]:
        conv, bn = mnist_shapes(b)
        convs(conv + d_trunk_shapes(b, 28, 1), f32)
        bns(bn, f32, True)
    for b in batches["micro"]["cifar10"]:
        convs(conv_shapes(b) + d_trunk_shapes(b, 32, 3), f32)
        bns(bn_shapes(b), f32, True)
    for dtype in (f32, torch.bfloat16):
        convs(d_trunk_shapes(50, 28, 1) + d_trunk_shapes(64, 32, 3), dtype)
    for b in batches["E"]["mnist"]:
        conv, bn = mnist_shapes(b)
        convs(conv, f32)
        bns([r for r in bn if "E/D." in r[0]], f32, False)
    for b in batches["fused"]["cifar10"]:
        convs(d_trunk_shapes(b, 32, 3), f32)


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
    _check_family2(gen, errs, misses, seen)
    _check_family3(gen, errs, misses, seen)
    _check_phase_convs(gen, errs, misses, seen)
    _check_quality_run(gen, errs, misses, seen)
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
    from graphical_gan_tpu_torch.ops.kernels import fused_norm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    card = torch.cuda.get_device_name(0)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        size = dtype.itemsize
        for b in (64, 256):
            for name, shape, cout, act in conv_shapes(b):
                row = _k1_timing_row(name, shape, cout, 5, 2, "SAME", act,
                                     dtype, gen, card)
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
    _time_family3(timings, card)


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
    # GMGAN mnist's q(k|x): E's three convs and two BNs
    "cluster": {"fused_conv2d_bias_act": 3, "bn_stats": 2, "bn_apply": 2},
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


DISPATCH_REPS = 20
# time_ms windows and calls of each dispatch reading: (5, 10), not PR
# 12's (7, 20), which take 10 s more of this phase (29.8-30.1 s against
# 19.9-20.0). With the int8-export phase and every other depth as PR 12
# had it, a run took 907.8 s, over PR 12's 894.6
DISPATCH_TIME_REPS, DISPATCH_TIME_INNER = 5, 10


def _profile(call, x):
    """(device busy / wall time, device ms per call by group, the largest
    kernels, kernel launches per call by group) of ``DISPATCH_REPS`` calls
    under ``torch.profiler``; the profiler's own host cost lengthens the
    wall time, so the busy share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graphical_gan_tpu_torch.tools.trace_report import kernel_group
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
        g = kernel_group(ev.key)
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
                    dev = time_ms(lambda a: fn(params, 0, a), (xd,),
                                  DISPATCH_TIME_REPS, DISPATCH_TIME_INNER)
                    torch.backends.cudnn.deterministic = False
                    try:
                        dev_free = time_ms(lambda a: fn(params, 0, a), (xd,),
                                           DISPATCH_TIME_REPS,
                                           DISPATCH_TIME_INNER)
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
            "conv_gemm_taps": (0, 0), "conv_gemm_im2col": (0, 0),
            "quantize_int8": (0, 0), "int8_conv": (0, 0),
            "bn_apply_q8": (0, 0)}
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
# a gradient g = sum t whose terms differ between the devices by GRAD_RTOL
# of their sum |t| differs by up to GRAD_RTOL / (|g| / sum |t|) of itself:
# at |g| / sum |t| <= CANCEL_MAX that can pass MOMENT_RTOL
CANCEL_MAX = GRAD_RTOL / MOMENT_RTOL
NOISE_REL = 1e-4
NOISE_FLOOR = 1e-6
# the mnist wali-gp parity runs k = 2 critic updates (4 D updates in 2
# iterations): at the published k = 5, 10 D updates of TF1 Adam's sign
# amplification through the BNs of the mnist D move G's iteration-1
# gradient enough that Adam's moments differ by up to 6.9% of a leaf's
# largest (G.5.Biases' v; H100 80GB HBM3, 700 W), with the first updates'
# gradients within 1.1e-5 of the CPU's
MNIST_PARITY_K = 2


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


def _traced_train(tr, iters, host=False):
    """``tr.train(iters)`` with the counts set to 0 just before it and read
    just after, under ``torch.profiler`` (CUDA activity; ``host`` adds the
    host's): (its last costs, the wrappers' counts, the counts with each
    training kernel's executions read off the device trace in place of
    its wrapper's, the seconds, the profile). A step graph's replay calls
    no wrapper, so only the trace sees what it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.tools import trace_report
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    t0 = time.perf_counter()
    kernels.reset_launches()
    with profile(activities=acts) as prof:
        metrics = tr.train(iters)
        torch.cuda.synchronize()
    got = kernels.launches()
    secs = time.perf_counter() - t0
    ran = {**got, **kernels.device_launches(trace_report.kernel_counts(prof))}
    return metrics, got, ran, secs, prof


def _per_iter_want(iters):
    """PER_ITER's launches over ``iters`` iterations from iteration 0."""
    return {k: a * iters + b for k, (a, b) in PER_ITER.items()}


def _python_iters(tr, iters):
    """Of ``iters`` iterations that ``tr`` ran, those whose step ran Python
    (the eager ones and each capture), which its wrappers counted."""
    return iters - (tr.replays - tr.captures)


def phase_train(launch_totals, data, k1_counts):
    """The training main path: per compute dtype, the counts are set to 0,
    the Trainer runs TRAIN_ITERS iterations on its step graph under
    ``torch.profiler``, and the counts are read; then the steady state is
    timed and profiled on the graph. ``launch_totals`` receives the
    launches summed over both dtypes (the training kernels' executions
    from the device trace), ``k1_counts`` K1's per dtype."""
    from graphical_gan_tpu_torch.tools.mfu import time_train
    from graphical_gan_tpu_torch.tools import trace_report
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_train")
    shutil.rmtree(base, ignore_errors=True)
    for dtype in ("float32", "bfloat16"):
        model = _published(dtype)
        tr = Trainer(model, data, os.path.join(base, dtype), seed=0,
                     device="cuda", checkpoint_every=0)
        metrics, got, ran, secs, prof = _traced_train(tr, TRAIN_ITERS,
                                                      host=True)
        by_name = trace_report.groups_by_name(trace_report.device_rows(prof))
        del prof
        captured = tr._graph.launches if tr._graph is not None else {}
        made = (tr.captures, tr.replays)
        for k, v in ran.items():
            launch_totals[k] = launch_totals.get(k, 0) + v
        k1_counts[(dtype, "train")] = ran["fused_conv2d_bias_act"]
        want = _per_iter_want(TRAIN_ITERS)
        python = _python_iters(tr, TRAIN_ITERS)
        want_wrappers = _per_iter_want(python)
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"train {dtype}: non-finite costs {metrics}")
        _finite_state(tr, f"train {dtype}")
        if made != (1, TRAIN_ITERS - 2):
            fail(f"train {dtype}: {tr.captures} captures, {tr.replays} "
                 f"replays (Trainer.eager_reason: {tr.eager_reason()})")
        if ran != want:
            fail(f"train {dtype}: kernel executions {ran} != {want}")
        if got != want_wrappers:
            fail(f"train {dtype}: wrapper launches {got} != {want_wrappers}"
                 f" ({python} iterations ran Python)")
        ms = time_train(tr, TIME_ITERS)
        busy, dev_ms, groups, top, host_ops, host_top = \
            trace_report.profile_train(tr, PROFILE_ITERS, by_name)
        if dtype == "float32":
            _custom_op_cost(tr)
        per_iter_images = (1 + model.cfg.critic_iters) * model.cfg.batch_size
        log({"phase": "train", "dtype": dtype, "dispatch": "step graph",
             "iters": TRAIN_ITERS, "seconds": round(secs, 3),
             "last_metrics": metrics, "launches": ran,
             "wrapper_launches": got, "iterations_that_ran_python": python,
             "captures": made[0], "replays": made[1],
             "capture_launches": captured, "ms_per_iter": ms,
             "images_per_s": per_iter_images / ms * 1e3,
             "busy_share": busy, "device_ms_per_iter": dev_ms,
             "device_ms_per_iter_by_group": groups,
             "top_kernels_ms_per_iter": top,
             "profiled_host_aten_ops_per_iter": host_ops,
             "profiled_host_self_ms_per_iter_top_ops": host_top})


class _ViaOps:
    """Eager kernel calls through their ``torch.library`` ops' dispatcher,
    as traced calls go (``ops/kernels/build.py: run_op`` sends eager calls
    straight to the CUDA implementation): for the host-cost reading."""

    def __enter__(self):
        from graphical_gan_tpu_torch.ops.kernels import build
        self.build, self.saved = build, build.run_op
        build.run_op = lambda op, impl, x, *args: op(x, *args)
        return self

    def __exit__(self, *exc):
        self.build.run_op = self.saved


OP_CALLS = 2000  # host-timed calls of each wrapper, through and around


def _per_call_us(fn, args):
    """Host µs of one call of ``fn(*args)`` (the kernel's launch queued),
    over OP_CALLS calls after a warm one."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OP_CALLS):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / OP_CALLS * 1e6


def _custom_op_cost(tr):
    """What the ``torch.library`` ops' dispatcher would cost the host: the
    published f32 step's host ms/iter and profiled aten ops per iteration
    on the eager dispatch (``Trainer._eager``; a replay calls no wrapper)
    as it runs (eager calls straight to the CUDA implementations) and with
    every kernel call through its op (``_ViaOps``), and each wrapper's
    host µs per call both ways (on tiny tensors, so the card keeps up and
    the loop times the host alone), which the step's calls per iteration
    turn into ms/iter. A reading, not a limit."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import (
        bn_apply, bn_stats, fused_conv2d_bias_act)
    from graphical_gan_tpu_torch.tools.mfu import time_train
    from graphical_gan_tpu_torch.tools.trace_report import profile_train
    x = torch.randn(2, 8, 8, 8, device="cuda")
    w = torch.randn(5, 5, 8, 8, device="cuda")
    b = torch.zeros(8, device="cuda")
    x2 = torch.randn(64, 8, device="cuda")
    m, _, inv = bn_stats(x2)
    one = torch.ones(8, device="cuda")
    calls = {"fused_conv2d_bias_act": (fused_conv2d_bias_act,
                                       (x, w, b, 2, "SAME", "leaky_relu")),
             "bn_stats": (bn_stats, (x2,)),
             "bn_apply": (bn_apply, (x2, m, inv, one, one, "relu"))}
    us = {}
    for name, (fn, args) in calls.items():
        direct = _per_call_us(fn, args)
        with _ViaOps():
            through = _per_call_us(fn, args)
        us[name] = {"ops_us": through, "direct_us": direct}
    per_iter = {k: a for k, (a, _) in PER_ITER.items()}
    tr._graph, tr._eager = None, True
    ms_direct = time_train(tr, TIME_ITERS)
    host_ops = profile_train(tr, PROFILE_ITERS)[4]
    with _ViaOps():
        ms_ops = time_train(tr, TIME_ITERS)
        prof = profile_train(tr, PROFILE_ITERS)
    log({"check": "custom-op dispatch cost", "dtype": "float32",
         "dispatch": "eager",
         "ms_per_iter_ops": ms_ops, "ms_per_iter_direct": ms_direct,
         "per_call_host_us": us,
         "host_ms_per_iter_from_per_call": sum(
             per_iter[k] * (v["ops_us"] - v["direct_us"])
             for k, v in us.items()) / 1e3,
         "profiled_host_aten_ops_per_iter_ops": prof[4],
         "profiled_host_aten_ops_per_iter_direct": host_ops,
         "profiled_host_top_ops_ops": prof[5]})


def _grads(model, params, raw, draws, player):
    import torch
    from graphical_gan_tpu_torch.core.registry import merge, partition
    names = model.GEN_PLAYER if player == "gen" else model.DISC_PLAYER
    mine, _ = partition(params, names)
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in mine.items()}
    merged = merge(params, leaves)
    fn = model.gen_loss if player == "gen" else model.disc_loss
    loss = fn(merged, raw, draws=draws)[0]
    return dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))


def phase_train_parity():
    """cifar10 wali-gp: 2 iterations on the card against the CPU."""
    model = _published("float32")
    _train_parity(model, "cifar10 wali-gp", seed=3)


def _parity_inputs(model, seed):
    """Raw batches [2, 1+k, B, D] in the dataset's convention, and the
    draws of 2 iterations by the model's names, stacked over the updates:
    family 1's p_z [2, 1+k, B, z] and, for wali-gp, alpha [2, k, B, 1];
    GMGAN's prior eps and component [2, 1+k, B, ...] and, for the Gumbel
    modes, the posterior's uniforms."""
    import numpy as np
    import torch
    cfg = model.cfg
    k, b = cfg.critic_iters, cfg.batch_size
    rng = np.random.default_rng(seed)
    lead = (2, 1 + k, b)
    if hasattr(cfg, "seq_len"):
        return _ssgan_parity_inputs(cfg, rng, lead)
    shape = (2, 1 + k, b, cfg.data.output_dim)
    raw = rng.random(shape, dtype=np.float32) \
        if cfg.data.normalization == "unit" \
        else rng.integers(0, 256, shape).astype(np.float32)
    if hasattr(cfg, "n_coms"):
        noise = {"hyper_p_z": rng.standard_normal(lead + (cfg.dim_latent,)),
                 "prior_idx": rng.integers(0, cfg.n_coms, lead)}
        if cfg.mode_k in ("CONCRETE", "STRAIGHT_THROUGHT_CONCRETE"):
            noise["gumbel_q"] = rng.random(lead + (cfg.n_coms,))
    else:
        noise = {"p_z": rng.standard_normal(lead + (cfg.dim_latent,))}
        if cfg.mode == "wali-gp":
            noise["alpha"] = rng.random((2, k, b, 1))
    return torch.from_numpy(raw), {
        n: torch.from_numpy(t if t.dtype == np.int64
                            else t.astype(np.float32))
        for n, t in noise.items()}


def _ssgan_parity_inputs(cfg, rng, lead):
    """SSGAN's raw batches (moving-MNIST ``{'x': videos, 'y': one-hot}``,
    chairs pixel videos) and draws ``p_z_l_0``, ``epsilon``, ``p_z_g`` and,
    conditional, ``p_y``, each [2, 1+k, B, ...]."""
    import numpy as np
    import torch
    shape = lead + (cfg.seq_len, cfg.output_dim)
    if cfg.dataset == "chairs":
        x = rng.integers(0, 256, shape).astype(np.float32)
    else:
        x = rng.random(shape, dtype=np.float32)
    raw = {"x": torch.from_numpy(x)}
    noise = {"p_z_l_0": rng.standard_normal(lead + (cfg.dim_latent_l,)),
             "epsilon": rng.standard_normal(lead + (cfg.dim_latent_t,)),
             "p_z_g": rng.standard_normal(lead + (cfg.dim_latent_g,))}
    if cfg.conditional:
        raw["y"] = torch.from_numpy(np.eye(cfg.n_classes, dtype=np.float32)[
            rng.integers(0, cfg.n_classes, lead)])
        noise["p_y"] = rng.integers(0, cfg.n_classes, lead)
    return raw, {n: torch.from_numpy(t if t.dtype == np.int64
                                     else t.astype(np.float32))
                 for n, t in noise.items()}


def _raw_at(raw, device, *idx):
    """Entry ``idx`` of a raw batch (a tensor or a dict of tensors) on
    ``device``."""
    from graphical_gan_tpu_torch.core import tree
    return tree.tree_map(lambda t: t[idx].to(device), raw)


def _update_draws(model, noise, it, j):
    """Update j's draws of iteration ``it`` (0 is G's, 1 + i D's i-th), as
    the step indexes them."""
    only = model.DISC_ONLY_DRAWS
    return {n: t[it, j - 1] if n in only else t[it, j]
            for n, t in noise.items() if j or n not in only}


def _step_noise(model, noise, it):
    """Iteration ``it``'s draws as the step takes them: with
    ``accum_steps = a`` each update's [B, ...] split into [a, B / a,
    ...]."""
    a = int(getattr(model.cfg, "accum_steps", 1) or 1)
    return {n: t[it] if a == 1 else t[it].reshape(
        t.shape[1:2] + (a, t.shape[2] // a) + t.shape[3:])
        for n, t in noise.items()}


def _bias_cancellation(model, params, raw, draws, player, leaf):
    """|g| / sum |t| for a bias leaf, the largest over its channels: g is
    the leaf's gradient and the terms t the loss's gradient at each output
    element of the leaf's layer (bias added, no activation fused), whose
    sum over the elements is g. None where the leaf is no bias, its layer
    fuses an activation, or the terms do not sum to g within 1e-5 of
    sum |t|."""
    import inspect
    import torch
    layer, _, kind = leaf.rpartition(".")
    if kind not in ("Biases", "b"):
        return None
    mod = sys.modules[type(model).__module__]
    terms, saved = [], {}

    def spy(fn):
        sig = inspect.signature(fn)

        def call(*a, **kw):
            out = fn(*a, **kw)
            args = sig.bind(*a, **kw).arguments
            if (args.get("name") == layer and args.get("act") is None
                    and out.requires_grad):
                out.register_hook(terms.append)
            return out
        return call

    for f in ("conv2d", "deconv2d", "conv3d", "linear"):
        if hasattr(mod, f):
            saved[f] = getattr(mod, f)
            setattr(mod, f, spy(saved[f]))
    try:
        g = _grads(model, params, raw, draws, player)[leaf].double()
    finally:
        for f, fn in saved.items():
            setattr(mod, f, fn)
    if not terms:
        return None
    t = torch.cat([x.double().reshape(-1, x.shape[-1]) for x in terms])
    total, mass = t.sum(0), t.abs().sum(0)
    if not bool(((total - g).abs() <= 1e-5 * mass).all()):
        return None
    return float((total.abs() / mass.clamp_min(1e-300)).max())


def _train_parity(model, label, seed, carried=False):
    """2 iterations on the card against the CPU (plain versions), f32, from
    the same params, batches and noise; and the first updates' gradients.
    A skipped and a reversed step fed to the same check must be refused.

    With ``carried``, an Adam moment of a G bias that misses its bound is
    held a second time, against the CPU's iteration 1 run from the card's
    own state after iteration 0, if its iteration-1 gradient (G's one
    update in the 2 iterations) is shown to cancel: |g| / sum |t| at most
    CANCEL_MAX (``_bias_cancellation``, on the CPU's state). Such a
    gradient moves with D's parameters, which already differ by the sign
    flips the parameter bound allows. The first misses, each leaf's
    cancellation and the second errors are logged. The parameters, the
    updates and the controls are held as before."""
    import torch
    from graphical_gan_tpu_torch.train.step import make_train_step
    k = model.cfg.critic_iters
    raw, noise = _parity_inputs(model, seed)
    params = model.init(seed=1, device="cpu")
    dev = {"cpu": torch.device("cpu"), "cuda": torch.device("cuda")}
    grads = {}
    for name, d in dev.items():
        on = {n: p.to(d) for n, p in params.items()}
        grads[name] = {
            pl: _grads(model, on, _raw_at(raw, d, 0, i),
                       {n: t.to(d) for n, t in
                        _update_draws(model, noise, 0, i).items()}, pl)
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

    def iteration(st, it, d):
        return step(st, _raw_at(raw, d, it), it > 0, noise={
            n: t.to(d) for n, t in _step_noise(model, noise, it).items()})[0]

    firsts = {}
    for name, d in dev.items():
        # copies: the step updates the parameters in place
        st = init_state({n: p.to(d, copy=True) for n, p in params.items()})
        st = iteration(st, 0, d)
        # the CPU's parameters copied: iteration 1 updates them in place
        firsts[name] = (_to_cpu_state(st) if name == "cuda" else
                        {n: p.clone() for n, p in st.params.items()})
        states[name] = iteration(st, 1, d)
    ref = states["cpu"]
    got = _to_cpu_state(states["cuda"])
    state_bad, report = _state_misses(ref, got, params, model, k)
    gen_leaves = {n for n in params if n.split(".")[0] in model.GEN_PLAYER}
    moments = [m for m in state_bad if m.split()[-1] in ("m", "v")]
    if carried and moments:
        report["first_moment_misses"] = moments
        cancel = {n: _bias_cancellation(
            model, firsts["cpu"], _raw_at(raw, dev["cpu"], 1, 0),
            _update_draws(model, noise, 1, 0), "gen", n)
            for n in sorted({m.split()[0] for m in moments} & gen_leaves)}
        report["cancellation"] = cancel
        report["cancel_max"] = CANCEL_MAX
        second = [m for m in moments if cancel.get(m.split()[0]) is not None
                  and cancel[m.split()[0]] <= CANCEL_MAX]
        if second:
            from_card = iteration(firsts["cuda"], 1, dev["cpu"])
            again, rep2 = _state_misses(from_card, got, params, model, k)
            report["carried_moment_err_of_max"] = {
                f"gen_opt|{m.split()[1]}|{m.split()[0]}":
                rep2["moment_err_of_max"][
                    f"gen_opt|{m.split()[1]}|{m.split()[0]}"]
                for m in second}
            state_bad = [m for m in state_bad
                         if m not in second or m in again]
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
# chunk: the trainer's chunked resident loop (train/trainer.py), JAX's
# dispatches of up to chunk_size iterations between host events

CHUNK_ITERS = 12        # windows 0-4 alone, 5, 6-7, 8-11
CHUNK_CKPT_EVERY = 8    # checkpoints at 7 and 11, inside the windows' ends
CHUNK_HOOK_EVERY = 6    # a hook at 5 and 11
CHUNK_RESUME_AT = 8     # a run stopped here resumes at a window boundary
CHUNK_NAN_AT = 9        # GGAN_FAULT_NAN_AT: inside the window 8-11
# GMGAN and SSGAN: 9 iterations (0-4 alone, then 5-8) at chunk 3 against 1
CHUNK_FAMILY_ITERS = 9
CHUNK_FAMILY_SIZE = 3
CHUNK_WARM_ITERS = 4    # the timing's Trainers: eager 0-1, capture at 2
CHUNK_TIME_ITERS = 30   # one warm window per chunk size, timed
CHUNK_PROFILE_ITERS = 5


def _raw_bytes(t):
    """A tensor's or array's bytes, for a bit-for-bit comparison."""
    import numpy as np
    import torch
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _run_arrays(tr):
    """Every array of ``tr``'s state and of each checkpoint in its run
    directory, its step and its logged costs."""
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
    out = {f"state/{k}": _raw_bytes(v)
           for k, v in ckpt_lib.state_leaves(tr.state).items()}
    out["step"] = tr.state.step
    for it, path in ckpt_lib.list_checkpoints(tr.outf):
        flat, extra = ckpt_lib.load_raw(path)
        out.update({f"ckpt_{it}/{k}": _raw_bytes(v)
                    for k, v in flat.items()})
        out[f"ckpt_{it}/extra"] = sorted(extra.items())
    for name in ("train disc cost", "train gen cost"):
        out[name] = sorted(tr.logger.history(name).items())
    return out


def _differ(a, b):
    """The keys of two ``_run_arrays`` that differ (all, where the key sets
    differ)."""
    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return sorted(k for k in a if a[k] != b[k])


def _chunk_trainer(model, data, path, chunk, eager=False, **kw):
    """A Trainer at ``chunk_size`` ``chunk``, on the eager dispatch where
    ``eager`` (else the step graph), that records its dispatch sizes
    (``.sizes``) and its hooks' iterations (``.hook_its``)."""
    from graphical_gan_tpu_torch.train.trainer import Trainer
    hook_its, sizes = [], []
    kw.setdefault("checkpoint_every", CHUNK_CKPT_EVERY)
    kw.setdefault("eval_hooks", {CHUNK_HOOK_EVERY:
                                 lambda t, i: hook_its.append(i)})
    tr = Trainer(model, data, path, seed=0, device="cuda",
                 checkpoints_to_keep=0, chunk_size=chunk,
                 render_curves=False, **kw)
    tr._eager = eager
    dispatch = tr.dispatch

    def counted(start, n, pend):
        sizes.append(n)
        return dispatch(start, n, pend)

    tr.dispatch, tr.sizes, tr.hook_its = counted, sizes, hook_its
    return tr


def _chunk_runs(label, make, iters, runs, launch_totals, misses,
                want=None, captures=1):
    """A run per ``(chunk_size, eager)`` of ``runs`` (``make(chunk,
    eager)`` builds its Trainer) under ``torch.profiler``
    (``_traced_train``): every run's arrays must equal the first's bit for
    bit, its launches (the training kernels' executions read off the
    device trace) the first's (and ``want`` where given, with the
    wrappers' counts ``want``'s for the iterations that ran Python), two
    chunk sizes give two dispatch patterns, and each graph run made
    ``captures`` captures, each eager run none. Returns the trainers."""
    out = []
    for chunk, eager in runs:
        tr = make(chunk, eager)
        _, got, ran, secs, prof = _traced_train(tr, iters)
        del prof
        _add(launch_totals, ran)
        out.append((tr, ran, secs, _run_arrays(tr), got))
    tr0, got0, _, arr0, _ = out[0]
    differ = sorted({k for _, _, _, arr, _ in out[1:]
                     for k in _differ(arr0, arr)})
    same_launches = all(got == got0 for _, got, _, _, _ in out)
    made = [tr.captures for tr, _, _, _, _ in out]
    wrappers_exact = all(
        w == _per_iter_want(_python_iters(tr, iters))
        for tr, _, _, _, w in out) if want else True
    log({"phase": "chunk", "run": label, "iters": iters,
         "runs": [{"chunk_size": c, "eager": e} for c, e in runs],
         "dispatches": [tr.sizes for tr, _, _, _, _ in out],
         "hook_iterations": [tr.hook_its for tr, _, _, _, _ in out],
         "seconds": [round(r[2], 3) for r in out], "captures": made,
         "replays": [tr.replays for tr, _, _, _, _ in out],
         "arrays_compared": len(arr0), "bit_identical": not differ,
         "differing": differ[:5], "launches": got0,
         "launches_equal": same_launches,
         "wrapper_launches": [w for _, _, _, _, w in out],
         **({"launches_per_iter_exact": got0 == want,
             "wrapper_launches_exact": wrappers_exact} if want else {})})
    chunks = {}
    for (chunk, _), (tr, _, _, _, _) in zip(runs, out):
        chunks.setdefault(chunk, tr.sizes)
    if differ or not same_launches or (want and got0 != want) \
            or not wrappers_exact \
            or len({tuple(v) for v in chunks.values()}) != len(chunks) \
            or made != [0 if e else captures for _, e in runs]:
        misses.append(f"{label}: differing {differ[:5]}, launches "
                      f"{[got for _, got, _, _, _ in out]} (want {want}), "
                      f"wrappers {[w for _, _, _, _, w in out]}, "
                      f"dispatches {chunks}, captures {made}")
    return [tr for tr, _, _, _, _ in out]


def _run_window(tr, n):
    """``n`` iterations from the state's step as the trainer's resident
    loop runs one window of them: dispatches of at most ``chunk_size``
    (100 at None), then the queued costs fetched in one copy."""
    cap = 100 if tr.chunk_size is None else tr.chunk_size
    start, pend = tr.state.step, []
    for it in range(start, start + n, cap):
        tr.dispatch(it, min(cap, start + n - it), pend)
    tr._drain(pend, inject=False)


def _window_busy(tr, n):
    """(device busy / wall time, device ms per iteration) of one ``n``-
    iteration window (``_run_window``) under ``torch.profiler``
    with CUDA activity only: the host runs nearly as it does unprofiled,
    and the profile's processing takes seconds, not the tens of seconds
    of ``trace_report.profile_train``'s host events (which read the same
    device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_window(tr, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        for ev in prof.key_averages() if ev.device_type != DeviceType.CPU)
    return busy_ms / wall_ms, busy_ms / n


def _chunk_timing(model, data, base, dtype):
    """Warm host ms per iteration of one CHUNK_TIME_ITERS window
    (``_run_window``, bounded by synchronizes) and the busy share and
    device ms per iteration of a CHUNK_PROFILE_ITERS window
    (``_window_busy``): a graph Trainer of ``model``, new and warm (its
    step graph captured), at chunk_size None and 1, then an eager one at
    None; and the graph Trainer's captures and the memory reserved after
    its capture: readings. New Trainers and the graph first: this order
    avoids a known defect, a profiled replay of a graph captured before
    other graphs came and went, with a profiler session without replays
    in between, which segfaulted in the replay (PyTorch 2.11, CUDA 12.8,
    an H100); ``tools/graph_profile_repro.py`` does not reproduce it
    without the port's Trainer, so its cause is not known."""
    import torch
    graph, eager = (_chunk_trainer(model, data, os.path.join(
        base, f"timing_{dtype}_{kind}"), None, kind == "eager",
        checkpoint_every=0, eval_hooks={}) for kind in ("graph", "eager"))
    for tr in (graph, eager):
        tr.train(CHUNK_WARM_ITERS)
    rec = {"phase": "chunk", "run": "timing", "dtype": dtype,
           "window": CHUNK_TIME_ITERS, "profiled": CHUNK_PROFILE_ITERS}
    for tr, kind, chunk in ((graph, "graph", None), (graph, "graph", 1),
                            (eager, "eager", None)):
        tr.chunk_size = chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_window(tr, CHUNK_TIME_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / CHUNK_TIME_ITERS
        busy, dev_ms = _window_busy(tr, CHUNK_PROFILE_ITERS)
        key = f"{kind}_chunk_{'none' if chunk is None else chunk}"
        rec.update({f"ms_per_iter_{key}": ms, f"busy_share_{key}": busy,
                    f"device_ms_per_iter_{key}": dev_ms})
    rec["ms_ratio_graph_over_eager"] = (rec["ms_per_iter_graph_chunk_none"]
                                        / rec["ms_per_iter_eager_chunk_none"])
    rec["graph_captures"] = graph.captures
    rec["graph_mib_reserved_after_capture"] = graph._graph.reserved / 2 ** 20
    log(rec)


def phase_chunk(launch_totals, data):
    """The chunked resident loop and its step graph on the card: per
    compute dtype, the published cifar10 wali-gp Trainer, the graph at
    chunk_size None and 1 against the eager dispatch at None, over
    CHUNK_ITERS iterations (checkpoints, a hook and the early boundaries
    inside), bit for bit (parameters, Adam's m, v and t, step, every
    logged cost, every checkpoint array), its launches PER_ITER's; then
    the timing readings on new Trainers. In f32 a resume at a window
    boundary under the graph against the eager run, and a rollback
    through GGAN_FAULT_NAN_AT inside a window, the graph (captured again
    after the restore) against the eager dispatch, each bit for bit. GMGAN mnist local_ep (resident),
    SSGAN moving-MNIST local_ep (the device pipeline's sampler) and
    cifar10 wali-gp with remat (its recomputes on their own generator
    states under the capture), the graph at chunk 3 against the eager
    dispatch at 1."""
    from graphical_gan_tpu_torch.core.config import gmgan_defaults
    from graphical_gan_tpu_torch.runs import gmgan as gm
    from graphical_gan_tpu_torch.runs.gan_inference import resident_data
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_chunk")
    shutil.rmtree(base, ignore_errors=True)
    misses = []
    want = _per_iter_want(CHUNK_ITERS)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model = _published(dtype)
        runs[dtype] = _chunk_runs(
            f"cifar10 wali-gp {dtype}",
            lambda c, e: _chunk_trainer(model, data, os.path.join(
                base, f"{dtype}_{c}_{'eager' if e else 'graph'}"), c, e),
            CHUNK_ITERS, ((None, False), (1, False), (None, True)),
            launch_totals, misses, want)
        if runs[dtype][0].hook_its != [5, 11]:
            misses.append(f"{dtype}: hooks at {runs[dtype][0].hook_its}")
    model = _published("float32")
    # resume: a run stopped at a window boundary, continued by a new
    # Trainer, both on the graph, against the eager run
    path = os.path.join(base, "resume")
    _chunk_trainer(model, data, path, None).train(CHUNK_RESUME_AT)
    resumed = _chunk_trainer(model, data, path, None)
    resumed.train(CHUNK_ITERS)
    ref = _run_arrays(runs["float32"][2])
    for name in ("train disc cost", "train gen cost"):  # the resumed span
        ref[name] = [kv for kv in ref[name] if kv[0] >= CHUNK_RESUME_AT]
    differ = _differ(ref, _run_arrays(resumed))
    log({"phase": "chunk", "run": "resume", "resumed_at":
         resumed._start_iter, "dispatches": resumed.sizes,
         "captures": resumed.captures, "bit_identical": not differ,
         "differing": differ[:5]})
    if differ or resumed._start_iter != CHUNK_RESUME_AT \
            or resumed.captures != 1:
        misses.append(f"resume at {resumed._start_iter}: {differ[:5]}, "
                      f"captures {resumed.captures}")
    # rollback: the poison inside the window 8-11; the graph's Trainer
    # captures again after the restore
    old = os.environ.get("GGAN_FAULT_NAN_AT")
    os.environ["GGAN_FAULT_NAN_AT"] = str(CHUNK_NAN_AT)
    try:
        tr = _chunk_runs(
            "rollback cifar10 wali-gp float32",
            lambda c, e: _chunk_trainer(model, data, os.path.join(
                base, f"rollback_{c}_{e}"), c, e, max_rollbacks=1),
            CHUNK_ITERS, ((None, False), (1, True)), launch_totals, misses,
            captures=2)[0]
    finally:
        if old is None:
            os.environ.pop("GGAN_FAULT_NAN_AT", None)
        else:
            os.environ["GGAN_FAULT_NAN_AT"] = old
    with open(tr.logfile) as f:
        lines = [ln for ln in f if "divergence guard" in ln]
    log({"phase": "chunk", "run": "rollback", "rollbacks": tr._rollbacks,
         "salt": tr._salt, "guard_lines": [ln.strip() for ln in lines]})
    if tr._rollbacks != 1 or tr._salt != 1 or len(lines) != 1 \
            or f"iteration {CHUNK_NAN_AT};" not in lines[0]:
        misses.append(f"rollback: {tr._rollbacks} rollbacks, salt "
                      f"{tr._salt}, lines {lines}")
    # GMGAN (resident) and SSGAN (the device pipeline's sampler)
    gcfg = gmgan_defaults("mnist", "local_ep")
    gdata = resident_data(gcfg, None, gm._loaders(gcfg, None)[0])
    scfg = _ssgan_model("moving_mnist", "local_ep").cfg
    sdata, sampler = _family3_data(scfg, {})
    for label, build, d, kw in (
            ("gmgan mnist local_ep", lambda: _gmgan_model("mnist",
                                                          "local_ep"),
             gdata, {}),
            ("ssgan moving-MNIST local_ep device", lambda: _ssgan_model(
                "moving_mnist", "local_ep"), sdata,
             {"batch_sampler": sampler}),
            ("remat cifar10 wali-gp float32", lambda: _option_model(
                remat=True), data, {})):
        m = build()
        _chunk_runs(label, lambda c, e: _chunk_trainer(
            m, d, os.path.join(base, f"{label.split()[0]}_{c}_{e}"), c, e,
            checkpoint_every=0, eval_hooks={}, **kw),
            CHUNK_FAMILY_ITERS, ((CHUNK_FAMILY_SIZE, False), (1, True)),
            launch_totals, misses)
    for dtype in ("float32", "bfloat16"):
        _chunk_timing(_published(dtype), data, base, dtype)
    if misses:
        fail(f"chunk: {misses}")


# ---------------------------------------------------------------------------
# K3's own path and the rest of family 1

def phase_bench_conv(launch_totals):
    """K3's path: the port's ``tools/bench_conv_kernel.main()`` at its four
    bf16 shapes (its defaults ``--reps 0 --rounds 5 --n-inputs 4``: calls
    per timed run scaled to the shape, the median of 5 runs, 4 input
    sets), counts set to 0 before and read after."""
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
    from graphical_gan_tpu_torch.tools.mfu import time_train
    from graphical_gan_tpu_torch.tools.trace_report import profile_train
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
            ms = time_train(tr, FAMILY1_TIME_ITERS)
            busy, dev_ms, groups, top, host_ops, _ = profile_train(
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


# ---------------------------------------------------------------------------
# the train step's options and family 2 (GMGAN)

STEP_ACCUM = 2          # accum_steps of the step-options phase
DECAY_ITERS = 3
FAMILY2_ITERS = 3
# family 2 beyond mnist: (dataset, mode), CONCRETE, at published widths
FAMILY2_OTHER = (("cifar10", "local_ep"), ("svhn", "local_ep"),
                 ("celeba", "ali"))
# the family-2 run whose steady state is timed (FAMILY1_TIME_ITERS
# iterations) and profiled (PROFILE_ITERS) after its FAMILY2_ITERS: the
# learning check's config
FAMILY2_PROFILED = (("mnist", "local_ep", "CONCRETE"),)
# the cluster phase: each row of q(k|x) sums to 1 within CLUSTER_SUM_ATOL,
# and the card's probabilities equal the CPU's within CLUSTER_ATOL
CLUSTER_ATOL = 1e-4
CLUSTER_SUM_ATOL = 1e-5
# the learning check: mnist local_ep on the structured family for
# LEARN2_ITERS iterations, clustering accuracy at iteration LEARN2_ITERS-1
# at least LEARN2_MIN_ACC: the 5k run's value there (0.7385 at seed 0,
# H100 80GB HBM3 at 700 W; PERF.md) less a margin of 0.25 for the spread
# between runs (0.5655-0.7400 over seeds 0-3 on that card; seed 0 gives
# 0.7385 again in a fresh process, but 0.7320 here, after the other
# phases: which op's bits differ is not measured), and above 2x chance
# (0.20)
LEARN2_ITERS = 1000
LEARN2_MIN_ACC = 0.4885
LEARN2_CHANCE = 0.10


def _option_model(**overrides):
    """cifar10 wali-gp at the published config with step options."""
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    cfg = gan_inference_defaults("cifar10", "wali-gp", **overrides)
    if (cfg.batch_size, cfg.dim, cfg.dim_latent, cfg.critic_iters) \
            != (64, 64, 128, 5):
        fail(f"cifar10 wali-gp defaults changed: {cfg}")
    return GanInferenceModel(cfg)


def phase_step_options(launch_totals):
    """cifar10 wali-gp at B=64, k=5: 2 iterations on the card against the
    CPU with ``accum_steps``, ``remat`` and ``fused_gp``, held as
    train-parity holds the plain step; remat on the card bit-identical to
    no remat; and a celeba ali run with ``decay``, whose Adam step sizes
    are logged."""
    from graphical_gan_tpu_torch.ops import kernels
    kernels.reset_launches()
    for label, kw in (("accum_steps", dict(accum_steps=STEP_ACCUM)),
                      ("remat", dict(remat=True)),
                      ("fused_gp", dict(fused_gp=True))):
        model = _option_model(**kw)
        if label == "fused_gp" and not model._fused_gp():
            fail("cifar10 wali-gp does not take the fused penalty")
        _train_parity(model, f"cifar10 wali-gp {label}={kw[label]}",
                      seed=6)
    _remat_bit_identity()
    _add(launch_totals, kernels.launches())
    _decay_run(launch_totals)


def _remat_bit_identity():
    """Two iterations with and without remat from one init and one seeded
    generator on the card (the draws come from it, so the recompute must
    replay them): the same bits."""
    import torch
    from graphical_gan_tpu_torch.train.step import make_train_step
    raw, _ = _parity_inputs(_option_model(), seed=8)
    params = _option_model().init(seed=2, device="cuda")
    out = {}
    for remat in (False, True):
        step, init = make_train_step(_option_model(remat=remat))
        st = init({n: p.clone() for n, p in params.items()})
        gen = torch.Generator(device="cuda")
        costs = []
        for it in range(2):
            gen.manual_seed(50 + it)
            st, met = step(st, raw[it].cuda(), it > 0, gen)
            costs.append({k: float(v) for k, v in met.items()})
        out[remat] = (st.params, costs)
    same = all(torch.equal(out[True][0][n], out[False][0][n])
               for n in params)
    log({"phase": "step-options", "check": "remat bit identity",
         "iters": 2, "params_bit_identical": same,
         "costs_equal": out[True][1] == out[False][1],
         "costs": out[True][1]})
    if not (same and out[True][1] == out[False][1]):
        fail("remat on the card differs from the step without it")


def _decay_run(launch_totals):
    """celeba ali with ``decay`` through ``runs/gan_inference.run``: Adam's
    step size at its step t is the undecayed one times 1 - t / iters."""
    from graphical_gan_tpu_torch.optim.optimizers import Adam
    from graphical_gan_tpu_torch.runs.gan_inference import run
    seen = []
    lr_t = Adam.lr_t

    def spy(self, t):
        out = lr_t(self, t)
        if self.lr_scale is not None:
            plain = Adam(lr=self.lr, beta1=self.beta1, beta2=self.beta2,
                         eps=self.eps)
            seen.append((int(t), out, lr_t(plain, t)))
        return out

    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_decay")
    shutil.rmtree(base, ignore_errors=True)
    Adam.lr_t = spy
    try:
        (tr, metrics), got = _path_launches(
            run, "celeba", "ali", iters=DECAY_ITERS, decay=True,
            outdir=base, checkpoint_every=0, sample_every=10 ** 6,
            tsne_every=0, inception_every=0, device="cuda")
    finally:
        Adam.lr_t = lr_t
    _add(launch_totals, got)
    iters = tr.cfg.iters
    bad = [(t, v, u) for t, v, u in seen
           if not math.isclose(v, u * max(0.0, 1.0 - t / iters),
                               rel_tol=1e-6)]
    log({"phase": "step-options", "check": "decay", "model": "celeba ali",
         "cfg_iters": iters, "lr_t_at_step": sorted(set(
             (t, v) for t, v, _ in seen if t in (1, 2))),
         "last_metrics": metrics, "launches": got, "misses": bad})
    if bad or {t for t, _, _ in seen} != set(range(1, DECAY_ITERS + 1)) \
            or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"decay: step sizes {seen} (off: {bad}), costs {metrics}")
    if not got.get("fused_conv2d_bias_act"):
        fail(f"decay: K1 never launched {got}")


def _gmgan_model(dataset, mode, mode_k="CONCRETE"):
    """The published config (core/config.py: gmgan_defaults)."""
    from graphical_gan_tpu_torch.core.config import gmgan_defaults
    from graphical_gan_tpu_torch.models.gmgan import GMGanModel
    cfg = gmgan_defaults(dataset, mode, mode_k=mode_k)
    want = {"mnist": (50, 64, 30), "cifar10": (64, 64, 30),
            "svhn": (64, 64, 50), "celeba": (128, 32, 100)}[dataset]
    if (cfg.batch_size, cfg.dim_g or cfg.dim, cfg.n_coms) != want:
        fail(f"gmgan {dataset} {mode} defaults changed: {cfg}")
    return GMGanModel(cfg)


def phase_family2(launch_totals):
    """3 Trainer iterations of each of the 5 modes under each of the 4
    MODE_K on mnist, and of cifar10 and svhn local_ep and celeba ali, at
    published widths on resident synthetic data (``runs/gmgan.py``'s
    loaders): finite costs and parameters, K1 launched, K2a-d where BN is
    on."""
    from graphical_gan_tpu_torch.tools.mfu import time_train
    from graphical_gan_tpu_torch.tools.trace_report import profile_train
    import torch
    from graphical_gan_tpu_torch.core.config import GMGAN_MODES, MODE_KS
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.runs import gmgan as gm
    from graphical_gan_tpu_torch.runs.gan_inference import resident_data
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_family2")
    shutil.rmtree(base, ignore_errors=True)
    runs = [("mnist", m, k) for m in GMGAN_MODES for k in MODE_KS] + [
        (ds, m, "CONCRETE") for ds, m in FAMILY2_OTHER]
    data = {}
    for dataset, mode, mode_k in runs:
        model = _gmgan_model(dataset, mode, mode_k)
        cfg = model.cfg
        if dataset not in data:
            data[dataset] = resident_data(cfg, None,
                                          gm._loaders(cfg, None)[0])
        tr = Trainer(model, data[dataset],
                     os.path.join(base, f"{dataset}_{mode}_{mode_k}"),
                     seed=0, device="cuda", checkpoint_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        metrics = tr.train(FAMILY2_ITERS)
        torch.cuda.synchronize()
        got = kernels.launches()
        _add(launch_totals, got)
        missing = [k for k in _expected_kernels(cfg) if not got[k]]
        row = {"phase": "family2", "dataset": dataset, "mode": mode,
               "mode_k": mode_k, "batch": cfg.batch_size,
               "dim": cfg.dim_g or cfg.dim, "z": cfg.dim_latent,
               "n_coms": cfg.n_coms, "bn": cfg.bn, "k": cfg.critic_iters,
               "iters": FAMILY2_ITERS,
               "seconds": round(time.perf_counter() - t0, 3),
               "last_metrics": metrics, "launches": got}
        if (dataset, mode, mode_k) in FAMILY2_PROFILED:
            ms = time_train(tr, FAMILY1_TIME_ITERS)
            busy, dev_ms, groups, top, host_ops, _ = profile_train(
                tr, PROFILE_ITERS)
            images = (1 + cfg.critic_iters) * cfg.batch_size
            row.update(ms_per_iter=ms, images_per_s=images / ms * 1e3,
                       busy_share=busy, device_ms_per_iter=dev_ms,
                       device_ms_per_iter_by_group=groups,
                       top_kernels_ms_per_iter=top,
                       profiled_host_aten_ops_per_iter=host_ops)
        log(row)
        if not metrics or not all(math.isfinite(v)
                                  for v in metrics.values()):
            fail(f"family2 {dataset} {mode} {mode_k}: costs {metrics}")
        _finite_state(tr, f"family2 {dataset} {mode} {mode_k}")
        if missing:
            fail(f"family2 {dataset} {mode} {mode_k}: kernels never "
                 f"launched {missing}")


def _argmax_flips(model, params, raw):
    """Rows of one batch whose q(k|x) argmax differs between the card and
    the CPU, with the CPU's top-two logit margin at each."""
    import torch
    with torch.no_grad():
        logits = {}
        for d in ("cpu", "cuda"):
            on = {n: p.to(d) for n, p in params.items()}
            z = model.encode(on, raw.to(d))
            logits[d] = model.component_logits(on, z).cpu()
    top = logits["cpu"].topk(2, dim=1).values
    rows = (logits["cpu"].argmax(1) != logits["cuda"].argmax(1)).nonzero()
    return [{"row": int(r), "cpu_top2_margin": float(top[r, 0] - top[r, 1])}
            for r in rows.flatten()]


def phase_family2_parity():
    """mnist local_ep CONCRETE and mnist ali REINFORCE: 2 iterations on the
    card against the CPU from the same params, batches and draws, the
    controls refused; q(k|x)'s argmax flips between the two devices on the
    first batches are logged with their margins."""
    for mode, mode_k in (("local_ep", "CONCRETE"), ("ali", "REINFORCE")):
        model = _gmgan_model("mnist", mode, mode_k)
        raw, _ = _parity_inputs(model, seed=4)
        params = model.init(seed=1, device="cpu")
        log({"phase": "family2-parity", "model": f"mnist {mode} {mode_k}",
             "argmax_flips": {f"update {j}": _argmax_flips(
                 model, params, raw[0, j]) for j in (0, 1)}})
        _train_parity(model, f"mnist {mode} {mode_k}", seed=4)


def phase_cluster(launch_totals):
    """A gmgan mnist local_ep run directory (published width, random
    weights from a seed) served over HTTP: the sampler with server-drawn
    one-hot and normal priors, and the cluster entry, whose q(k|x) rows
    sum to 1 and equal the CPU's."""
    import numpy as np
    from graphical_gan_tpu_torch.core.config import asdict
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    model = _gmgan_model("mnist", "local_ep")
    run_dir = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                           "smoke_gmgan_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(asdict(model.cfg), f, default=str)
    save_params(os.path.join(run_dir, "ckpt_0.npz"),
                model.init(seed=0, device="cuda"), {"iteration": 0})
    raw = np.random.default_rng(10).random((300, 784), dtype=np.float32)
    kernels.reset_launches()
    _drive_entry(run_dir, "sampler", raw, 784)
    outs = _drive_entry(run_dir, "cluster", raw, model.cfg.n_coms)
    _add(launch_totals, kernels.launches())
    cpu, _, _, _ = sampler_from_run_dir(run_dir, entry="cluster",
                                        device="cpu")
    ref = cpu(9, raw[:64])
    e = float(np.abs(outs["exact64"] - ref).max())
    sums = max(float(np.abs(o.sum(axis=1) - 1.0).max())
               for o in outs.values())
    log({"phase": "cluster", "gpu_vs_cpu_max_abs_err": e,
         "atol": CLUSTER_ATOL, "row_sum_max_abs_err": sums,
         "row_sum_atol": CLUSTER_SUM_ATOL,
         "argmax_agree": float((outs["exact64"].argmax(1)
                                == ref.argmax(1)).mean())})
    if not (e <= CLUSTER_ATOL and sums <= CLUSTER_SUM_ATOL):
        fail(f"cluster: the card's q(k|x) differs from the CPU's by {e}, "
             f"rows sum to 1 within {sums}")


def learn2_misses(acc) -> list:
    """What the family-2 learning check refuses: no accuracy, or one below
    LEARN2_MIN_ACC (which is above twice chance)."""
    if acc is None or not math.isfinite(acc):
        return [f"no finite testing accuracy: {acc}"]
    if not acc >= LEARN2_MIN_ACC:
        return [f"clustering accuracy {acc} < {LEARN2_MIN_ACC}"]
    return []


def phase_family2_learn(launch_totals):
    """``runs/gmgan.run("mnist", "local_ep", data_dir="structured")`` for
    LEARN2_ITERS iterations with the accuracy hook at the last one; its
    ``testing accuracy`` held to LEARN2_MIN_ACC."""
    from graphical_gan_tpu_torch.runs.gmgan import run
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_family2_learn")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    (tr, metrics), got = _path_launches(
        run, "mnist", "local_ep", iters=LEARN2_ITERS, data_dir="structured",
        outdir=base, eval_every=LEARN2_ITERS, checkpoint_every=0,
        device="cuda")
    _add(launch_totals, got)
    with open(tr.logfile) as f:
        accs = _log_values(f.read(), "testing accuracy")
    acc = accs.get(LEARN2_ITERS)
    misses = learn2_misses(acc)
    missing = [k for k in TRAIN_KERNELS if not got.get(k)]
    if missing:
        misses.append(f"kernels never launched {missing}")
    log({"phase": "family2-learn", "iters": LEARN2_ITERS,
         "seconds": round(time.perf_counter() - t0, 3),
         "testing_accuracy": acc, "min_acc": LEARN2_MIN_ACC,
         "chance": LEARN2_CHANCE, "last_metrics": metrics, "launches": got,
         "misses": misses})
    if misses:
        fail(f"family2-learn: {misses}")


# ---------------------------------------------------------------------------
# family 3 (SSGAN)

FAMILY3_ITERS = 3
POS_MODES = ("naive_mean_field", "inverse", "forward_inverse", "gsp")
# the family3 phase's Trainer runs at published widths: moving-MNIST
# local_ep under each pos_mode, the other modes and video Ds, chairs
FAMILY3_RUNS = tuple(
    [("moving_mnist", "local_ep", (("pos_mode", p),)) for p in POS_MODES]
    + [("moving_mnist", "local_epce-z", ()),
       ("moving_mnist", "ali", (("ali_mode", "concat_x"),)),
       ("moving_mnist", "ali", (("ali_mode", "concat_z"),)),
       ("moving_mnist", "ali", (("ali_mode", "3dcnn"),)),
       ("moving_mnist", "alice-z", ()),
       ("chairs", "local_ep", ())])
# the family-3 run timed and profiled after its iterations
FAMILY3_PROFILED = ("moving_mnist", "local_ep", (("pos_mode", POS_MODES[0]),))
# chairs' synthetic clips for the family3 run: 100 train chairs (two
# batches of 50), the rest dev (chairs_64.npy is not on the machine)
FAMILY3_CHAIRS = {"num_dev": 50, "synthetic_size": 150}
# family3-parity: videos per batch (the widths, LEN and every other field
# published; the CPU side of 2 iterations at B 50 would take minutes)
FAMILY3_PARITY_BATCH = 10
# family3-serve: rows of the reconstructor request held to the CPU
FAMILY3_SERVE_ROWS = 8
# family3-learn: moving-MNIST local_ep on the structured digits, bf16, the
# device pipeline; the hook before training and every LEARN3_EVERY. The
# reading at LEARN3_ITERS must be at most LEARN3_MAX_RATIO of the reading
# before training (the one at 500 is logged)
LEARN3_ITERS = 1000
LEARN3_EVERY = 500
LEARN3_MAX_RATIO = 0.5


def _ssgan_model(dataset, mode, **overrides):
    """The published config (core/config.py: ssgan_defaults), any field
    but the widths and LEN overridable."""
    from graphical_gan_tpu_torch.core.config import ssgan_defaults
    from graphical_gan_tpu_torch.models.ssgan import SSGanModel
    cfg = ssgan_defaults(dataset, mode, **overrides)
    want = {"moving_mnist": (16, 32, 1, 10, 128, 8, 256, "res"),
            "chairs": (31, 32, 3, 0, 128, 8, 256, "res_w")}[dataset]
    got = (cfg.seq_len, cfg.dim, cfg.channels, cfg.n_classes,
           cfg.dim_latent_g, cfg.dim_latent_l, cfg.dim_op, cfg.op_dyn_mode)
    if got != want or ("batch_size" not in overrides
                       and cfg.batch_size != 50):
        fail(f"ssgan {dataset} {mode} defaults changed: {cfg}")
    return SSGanModel(cfg)


def family3_batches() -> dict:
    """The video batches family 3 runs K1 (and K2) at, from the code's own
    constants: the published batch (training, the hook's n_vis samples and
    its dev batch, ``runs/ssgan.py: hook_inputs``), the parity batch, and
    the serving buckets (the reconstructor); chairs at its published
    batch; the frame batch of each is B·LEN."""
    from graphical_gan_tpu_torch.core.config import ssgan_defaults
    from graphical_gan_tpu_torch.runs.ssgan import hook_inputs
    mm, ch = ssgan_defaults("moving_mnist"), ssgan_defaults("chairs")
    hook = len(hook_inputs(mm, mm.batch_size)[0])
    return {"moving_mnist": sorted({mm.batch_size, hook, FAMILY3_PARITY_BATCH}
                                   | set(BUCKETS)),
            "chairs": [ch.batch_size]}


def ssgan_conv_shapes(cfg, b: int):
    """K1's calls at ``b`` videos: the per-frame stack (E and the frame
    D; B·LEN frames, Cin C), the whole-video stack (the global extractor
    and the concat_x D; B videos, Cin C·LEN) and concat_z's VALID D.5."""
    L, c, dim = cfg.seq_len, cfg.channels, cfg.dim
    tag = f"{cfg.dataset} "
    out = []
    for name, n, cin in (("frame", b * L, c), ("video", b, c * L)):
        out += [(f"{tag}{name}.1 leaky", (n, 64, 64, cin), dim, 5, 2,
                 "SAME", "leaky_relu"),
                (f"{tag}{name}.2", (n, 32, 32, dim), 2 * dim, 5, 2, "SAME",
                 None),
                (f"{tag}{name}.3", (n, 16, 16, 2 * dim), 4 * dim, 5, 2,
                 "SAME", None),
                (f"{tag}{name}.4", (n, 8, 8, 4 * dim), 8 * dim, 5, 2,
                 "SAME", None)]
    out.append((f"{tag}concat_z D.5 VALID", (b * L, 4, 4, 8 * dim),
                cfg.dim_latent_g, 4, 1, "VALID", None))
    return out


def ssgan_bn_shapes(cfg, b: int):
    """(name, (R, C), act) of every BN with ``bn=True`` at ``b`` videos:
    G's dense BN1 over [B·LEN, 4096] and its conv BNs, the frame stack's
    (E, frame D), the video stack's and the 3dcnn's 5-D BNs (R = B · T ·
    H · W at its temporal strides)."""
    L, dim = cfg.seq_len, cfg.dim
    f = b * L
    out = [("G.BN1 dense", (f, 16 * 8 * dim), "relu"),
           ("G.BN2", (f * 64, 4 * dim), "relu"),
           ("G.BN3", (f * 256, 2 * dim), "relu"),
           ("G.BN4", (f * 1024, dim), "relu")]
    for name, n in (("frame", f), ("video", b)):
        out += [(f"{name}.BN2", (n * 256, 2 * dim), "leaky_relu"),
                (f"{name}.BN3", (n * 64, 4 * dim), "leaky_relu"),
                (f"{name}.BN4", (n * 16, 8 * dim), "leaky_relu")]
    t, widths = L, (dim, 2 * dim, 4 * dim, 8 * dim)
    sls = (2, 1 if L == 4 else 2, 2, 1 if L == 4 else 2)
    for i, sl in enumerate(sls):
        t = -(-t // sl)
        if i:
            hw = 64 // 2 ** (i + 1)
            out.append((f"3dcnn 5-D BN{i + 1}", (b * t * hw * hw, widths[i]),
                        "leaky_relu"))
    return out


def _check_family3(gen, errs, misses, seen):
    """K1 at family 3's shapes (``family3_batches``) in f32 and bf16, each
    called twice for the same bits; with ``bn=True``, at the same batches
    and in both dtypes, K2a/K2b and K2c+K2d at every BN shape
    (``ssgan_bn_shapes``)."""
    import torch
    from graphical_gan_tpu_torch.core.config import ssgan_defaults
    batches = family3_batches()
    log({"check": "family3 batches", **batches})
    for dataset, bs in batches.items():
        cfg = ssgan_defaults(dataset)
        for b in bs:
            rows = ssgan_conv_shapes(cfg, b)
            if b != cfg.batch_size:  # concat_z trains at the batch alone
                rows = rows[:-1]
            for dtype in (torch.float32, torch.bfloat16):
                for name, shape, cout, k, s, pad, act in rows:
                    x, w, bias = _conv_inputs(shape, cout, dtype, gen, k)
                    _check_conv(f"{name} B={shape[0]}", x, w, bias, s, pad,
                                act, errs, misses, seen)
    for dataset, bs in batches.items():
        cfg = ssgan_defaults(dataset, bn=True)
        for b in bs:
            for dtype in (torch.float32, torch.bfloat16):
                for name, rc, act in ssgan_bn_shapes(cfg, b):
                    x, scale, offset = _bn_inputs(rc, dtype, gen)
                    label = f"{cfg.dataset} {name} R={rc[0]}"
                    _check_bn(label, x, scale, offset, act, 0.0, errs,
                              misses)
                    g = _bn_cotangents(x, gen)[1][1]
                    _check_bn_bwd(f"{label}+corr", x, g, scale, offset,
                                  act, errs, misses)


def _k1_timing_row(name, shape, cout, k, s, pad, act, dtype, gen, card):
    """K1 on random inputs of ``shape`` (NHWC) to ``cout`` channels, k x k
    at stride ``s`` with ``pad``: its time, its plain version's,
    ``F.conv2d`` + bias + act's on the padded input, and the bound (taps in
    the padding left out)."""
    import torch
    import torch.nn.functional as F
    from graphical_gan_tpu_torch.ops.activations import activation
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    dn = str(dtype).split(".")[1]
    x, w, bias = _conv_inputs(shape, cout, dtype, gen, k)
    bb, h, wd, cin = shape
    oh = fused_conv.out_size(h, k, s, pad)
    ow = fused_conv.out_size(wd, k, s, pad)
    (plo, phi), (qlo, qhi) = fused_conv._pads(h, wd, k, k, s, pad)
    xpad = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi)
                 ).contiguous(memory_format=torch.channels_last)
    wlib = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    act_fn = activation(act)
    taps = ((conv_valid_taps(h, k, s, plo) if pad == "SAME" else k * oh)
            * (conv_valid_taps(wd, k, s, qlo) if pad == "SAME" else k * ow))
    flops = 2.0 * bb * cout * cin * taps
    nbytes = (x.numel() + bb * oh * ow * cout + w.numel() + cout
              ) * dtype.itemsize
    t_b, by = bound(flops, nbytes, dn)
    p = _plan_of(x, w, s, pad)
    return {"kernel": "fused_conv2d_bias_act", "shape": name, "B": bb,
            "dtype": dn, "card": card, "path": p.path,
            "tile": [p.bm, p.bn], "splits": p.splits,
            "ms": time_ms(lambda *a: fused_conv.fused_conv2d_bias_act(
                *a, s, pad, act), (x, w, bias)),
            "plain_ms": time_ms(
                lambda *a: fused_conv.fused_conv2d_bias_act_plain(
                    *a, s, pad, act), (x, w, bias)),
            "library_ms": time_ms(
                lambda *a: act_fn(F.conv2d(*a, stride=s)),
                (xpad, wlib, bias.to(dtype))),
            "bound_ms": t_b, "bound_by": by, "flops": flops,
            "bytes": nbytes}


def _time_family3(timings, card):
    """K1 at family 3's frame shapes (moving-MNIST and chairs at B 50:
    every conv of the per-frame and whole-video stacks and the VALID D.5)
    in f32 and bf16 (``_k1_timing_row``)."""
    import torch
    from graphical_gan_tpu_torch.core.config import ssgan_defaults
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for dataset in ("moving_mnist", "chairs"):
        cfg = ssgan_defaults(dataset)
        for dtype in (torch.float32, torch.bfloat16):
            for name, shape, cout, k, s, pad, act in ssgan_conv_shapes(
                    cfg, cfg.batch_size):
                row = {**_k1_timing_row(name, shape, cout, k, s, pad, act,
                                        dtype, gen, card), "family": 3}
                timings.append(row)
                log({"timing": row})


def _family3_data(cfg, cache):
    """(resident data, batch sampler) as ``runs/ssgan.run`` builds them:
    moving-MNIST's digit pool for the device pipeline (the loader's
    synthetic MNIST), chairs' synthetic clips (FAMILY3_CHAIRS) resident."""
    from graphical_gan_tpu_torch.data import chairs
    from graphical_gan_tpu_torch.data.common import materialize_epoch
    from graphical_gan_tpu_torch.data.ondevice_moving_mnist import (
        make_video_sampler)
    from graphical_gan_tpu_torch.runs import ssgan
    if cfg.dataset not in cache:
        if cfg.dataset == "moving_mnist":
            cache[cfg.dataset] = ssgan.device_pool(cfg, None)
        else:
            cache[cfg.dataset] = materialize_epoch(chairs.load(
                cfg.seq_len, cfg.batch_size, **FAMILY3_CHAIRS)[0])
    sampler = make_video_sampler(cfg.seq_len) \
        if cfg.dataset == "moving_mnist" else None
    return cache[cfg.dataset], sampler


def phase_family3(launch_totals):
    """3 Trainer iterations of each FAMILY3_RUNS config at published widths
    (moving-MNIST on the device pipeline, chairs resident): finite costs and
    parameters, K1 launched; moving-MNIST local_ep then timed and profiled;
    then a moving-MNIST local_ep run with ``bn=True`` through ``run()``,
    which must launch K2a-d as well."""
    from graphical_gan_tpu_torch.tools.mfu import time_train
    from graphical_gan_tpu_torch.tools.trace_report import profile_train
    import torch
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.runs.ssgan import run
    from graphical_gan_tpu_torch.train.trainer import Trainer
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_family3")
    shutil.rmtree(base, ignore_errors=True)
    cache = {}
    for dataset, mode, over in FAMILY3_RUNS:
        model = _ssgan_model(dataset, mode, **dict(over))
        cfg = model.cfg
        data, sampler = _family3_data(cfg, cache)
        tag = "_".join([dataset, mode] + [str(v) for _, v in over])
        tr = Trainer(model, data, os.path.join(base, tag), seed=0,
                     device="cuda", checkpoint_every=0, batch_sampler=sampler)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        metrics = tr.train(FAMILY3_ITERS)
        torch.cuda.synchronize()
        got = kernels.launches()
        _add(launch_totals, got)
        row = {"phase": "family3", "dataset": dataset, "mode": mode,
               "pos_mode": cfg.pos_mode, "ali_mode": cfg.ali_mode,
               "batch": cfg.batch_size, "seq_len": cfg.seq_len,
               "dim": cfg.dim, "bn": cfg.bn, "iters": FAMILY3_ITERS,
               "seconds": round(time.perf_counter() - t0, 3),
               "last_metrics": metrics, "launches": got}
        if (dataset, mode, over) == FAMILY3_PROFILED:
            ms = time_train(tr, FAMILY1_TIME_ITERS)
            busy, dev_ms, groups, top, host_ops, _ = profile_train(
                tr, PROFILE_ITERS)
            frames = (1 + cfg.critic_iters) * cfg.batch_size * cfg.seq_len
            row.update(ms_per_iter=ms, frames_per_s=frames / ms * 1e3,
                       busy_share=busy, device_ms_per_iter=dev_ms,
                       device_ms_per_iter_by_group=groups,
                       top_kernels_ms_per_iter=top,
                       profiled_host_aten_ops_per_iter=host_ops)
        log(row)
        if not metrics or not all(math.isfinite(v)
                                  for v in metrics.values()):
            fail(f"family3 {tag}: costs {metrics}")
        _finite_state(tr, f"family3 {tag}")
        if not got.get("fused_conv2d_bias_act"):
            fail(f"family3 {tag}: K1 never launched {got}")
    t0 = time.perf_counter()
    (tr, metrics), got = _path_launches(
        run, "moving_mnist", "local_ep", iters=FAMILY3_ITERS,
        data_pipeline="device", outdir=os.path.join(base, "bn"),
        checkpoint_every=0, device="cuda", bn=True)
    _add(launch_totals, got)
    log({"phase": "family3", "dataset": "moving_mnist", "mode": "local_ep",
         "bn": True, "via": "run()", "iters": FAMILY3_ITERS,
         "seconds": round(time.perf_counter() - t0, 3),
         "last_metrics": metrics, "launches": got})
    missing = [k for k in TRAIN_KERNELS if not got.get(k)]
    if missing or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"family3 bn=True: kernels never launched {missing}, costs "
             f"{metrics}")


def phase_family3_parity():
    """moving-MNIST local_ep under gsp (both operator chains) and ali under
    3dcnn (the conv3d D), FAMILY3_PARITY_BATCH videos a batch: 2
    iterations on the card against the CPU from the same params, batches
    and draws, the controls refused."""
    for mode, over in (("local_ep", {"pos_mode": "gsp"}),
                       ("ali", {"ali_mode": "3dcnn"})):
        model = _ssgan_model("moving_mnist", mode,
                             batch_size=FAMILY3_PARITY_BATCH, **over)
        _train_parity(model, f"moving_mnist {mode} {over}", seed=6,
                      carried=True)


def phase_family3_serve(launch_totals):
    """A moving-MNIST local_ep run directory (published width, random
    weights from a seed) over HTTP: the sampler from server-drawn priors,
    the reconstructor from video and label rows; its answer to an
    ``exact`` FAMILY3_SERVE_ROWS-row request held to the CPU within
    E2E_ATOL."""
    import numpy as np
    from graphical_gan_tpu_torch.core.config import asdict
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import (
        sampler_from_run_dir, serve_run_dir)
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    model = _ssgan_model("moving_mnist", "local_ep")
    cfg = model.cfg
    run_dir = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                           "smoke_ssgan_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(asdict(cfg), f, default=str)
    save_params(os.path.join(run_dir, "ckpt_0.npz"),
                model.init(seed=0, device="cuda"), {"iteration": 0})
    rng = np.random.default_rng(11)
    x = rng.random((64, cfg.seq_len, cfg.output_dim), dtype=np.float32)
    y = np.eye(cfg.n_classes, dtype=np.float32)[rng.integers(0, 10, 64)]
    n = FAMILY3_SERVE_ROWS
    kernels.reset_launches()
    outs = {}
    for entry in ("sampler", "reconstructor"):
        httpd, batcher, _, warmup_s = serve_run_dir(
            run_dir, entry=entry, device="cuda", buckets=BUCKETS, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            cl = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
            if entry == "sampler":
                outs["sampler"] = [cl.sample(n=m, seed=m) for m in (1, 8, 64)]
            else:
                outs["exact"] = cl.sample(inputs=[x[:n], y[:n]], seed=9,
                                          exact=True)
                outs["batched"] = [cl.sample(inputs=[x[:m], y[:m]])
                                   for m in (1, 8, 64)]
            stats = cl.stats()
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(timeout=30)
        log({"phase": "family3-serve", "entry": entry,
             "warmup_s": round(warmup_s, 3), "stats": stats})
    got = kernels.launches()
    _add(launch_totals, got)
    for o in outs["sampler"] + outs["batched"] + [outs["exact"]]:
        if o.shape[1:] != (cfg.seq_len, cfg.output_dim) \
                or not np.isfinite(o).all() or np.abs(o).max() > 1.0:
            fail(f"family3-serve: output {o.shape}, finite "
                 f"{np.isfinite(o).all()}")
    cpu, _, _, _ = sampler_from_run_dir(run_dir, entry="reconstructor",
                                        device="cpu")
    e = float(np.abs(outs["exact"] - cpu(9, x[:n], y[:n])).max())
    log({"phase": "family3-serve", "rows": n,
         "reconstructor_gpu_vs_cpu_max_abs_err": e, "atol": E2E_ATOL,
         "launches": got})
    if not e <= E2E_ATOL:
        fail(f"family3-serve: the card's reconstruction differs from the "
             f"CPU's by {e} > {E2E_ATOL}")
    if not got.get("fused_conv2d_bias_act"):
        fail(f"family3-serve: K1 never launched {got}")


def ssgan_grid_misses(path: str, rows: int, cfg):
    """What is wrong with an SSGAN montage: rows videos by LEN frames of
    the frame size, gray or RGB, from its IHDR; and its GIF beside it."""
    from graphical_gan_tpu_torch.report.save_images import png_size
    if not os.path.isfile(path):
        return [f"{os.path.basename(path)} missing"]
    hgt, wdt = cfg.image_hw
    want = (cfg.seq_len * wdt, rows * hgt, 0 if cfg.channels == 1 else 2)
    got = png_size(path)
    miss = [] if got == want else [
        f"{os.path.basename(path)}: {got}, not {want}"]
    gif = path[:-4] + ".gif"
    if not os.path.isfile(gif):
        miss.append(f"{os.path.basename(gif)} missing")
    else:
        with open(gif, "rb") as f:
            if f.read(6) != b"GIF89a":
                miss.append(f"{os.path.basename(gif)} is not a GIF89a")
    return miss


def learn3_misses(recs) -> list:
    """What the family-3 learning check refuses: no reading before
    training (iteration 0) or at LEARN3_ITERS, a reading that is not
    finite, or the one at LEARN3_ITERS above LEARN3_MAX_RATIO of the one
    before training."""
    if (0 not in recs or LEARN3_ITERS not in recs
            or not all(math.isfinite(v) for v in recs.values())):
        return [f"dev rec l2 readings {recs}"]
    first, end = recs[0], recs[LEARN3_ITERS]
    if not end <= LEARN3_MAX_RATIO * first:
        return [f"dev rec l2 {end} at {LEARN3_ITERS} > {LEARN3_MAX_RATIO} "
                f"x {first} before training"]
    return []


def phase_family3_learn(launch_totals):
    """``tools/ssgan_learn.run_protocol`` at seed 0: ``runs/ssgan.run(
    "moving_mnist", "local_ep", data_dir="structured",
    data_pipeline="device", compute_dtype="bfloat16")``, the hook once
    before training, then LEARN3_ITERS iterations with the hook every
    LEARN3_EVERY; dev rec l2 held to ``learn3_misses`` and every montage
    to its size."""
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.tools.ssgan_learn import run_protocol
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_family3_learn")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    kernels.reset_launches()
    tr, recs, metrics = run_protocol(seed=0, iters=LEARN3_ITERS,
                                     every=LEARN3_EVERY, outdir=base)
    got = kernels.launches()
    _add(launch_totals, got)
    misses = learn3_misses(recs)
    cfg = tr.cfg
    for it in (0, LEARN3_EVERY - 1, LEARN3_ITERS - 1):
        for name, rows in (("samples", cfg.batch_size),
                           ("reconstruction", 2 * cfg.batch_size),
                           ("disentangle", 2 * cfg.batch_size)):
            misses += ssgan_grid_misses(
                os.path.join(tr.outf, f"{name}_{it}.png"), rows, cfg)
    if not got.get("fused_conv2d_bias_act"):
        misses.append(f"K1 never launched {got}")
    its = sorted(recs)
    log({"phase": "family3-learn", "iters": LEARN3_ITERS,
         "seconds": round(time.perf_counter() - t0, 3),
         "dev_rec_l2": recs, "max_ratio": LEARN3_MAX_RATIO,
         "ratio_at_end": recs[its[-1]] / recs[its[0]] if len(its) > 1
         else None,
         "last_metrics": metrics, "launches": got, "misses": misses})
    if misses:
        fail(f"family3-learn: {misses}")



# ---------------------------------------------------------------------------
# tools: the measurement tools of graphical_gan_tpu_torch/tools on the card

TOOL_PROFILE_START = 3   # GGAN_PROFILE window of the trace_report run
TOOL_PROFILE_ITERS = 5
TRACE_AGREE = 0.10       # trace_report's device ms vs profile_train's
SSGAN_TRACE_ITERS = 2
TOOL_ROUNDS = 1          # timed rounds of mfu and bench_families
TOOL_ITERS = 6           # iterations per round
SERVING_DEPTH = 10       # bench_serving: dispatches per timed window, one
SERVING_ROUNDS = 1       # window per family and batch
SERVER_REQUESTS = 10     # bench_server: requests per client
DET_CHUNK_ITERS = 4
DET_TRAINER_ITERS = 6
# GMGAN trainer iterations of the process replay (200 before the
# frozen-inception phase took that time, 100 before the split-kernels and
# int8-deconv phases did)
REPLAY_ITERS = 60
# GMGAN mnist local_ep at its published width: the config of the learning
# check (ROADMAP §3 fault 1)
REPLAY_DIM, REPLAY_B = 64, 50
# the share of the card's free memory the holder process takes during the
# last replay run
HOLD_SHARE = 0.9
_HOLDER_CODE = """
import sys
import torch
free = torch.cuda.mem_get_info()[0]
held = torch.empty(int(free * {share}), dtype=torch.uint8, device="cuda")
print("held", held.numel(), flush=True)
sys.stdin.read()
"""
_REPLAY_CODE = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from graphical_gan_tpu_torch.core.device import set_numerics
from graphical_gan_tpu_torch.tools import determinism
set_numerics()
model, cfg, resident = determinism._build("gmgan", {dim}, {b}, "mnist")
params = determinism.trainer_params(model, resident, {iters}, "cuda")
np.savez({out!r}, **params)
"""


def _trace_run(base, tag, tr, first, n):
    """``n`` iterations of ``tr`` or more traced by the trainer's
    GGAN_PROFILE hook from iteration ``first`` (the trace ends with the
    dispatch that reaches ``first + n``); returns the trace's directory."""
    out = os.path.join(base, tag)
    env = {"GGAN_PROFILE": out, "GGAN_PROFILE_START": str(first),
           "GGAN_PROFILE_STEPS": str(n)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        # one iteration past the window: the run's last checkpoint is
        # written outside it
        tr.train(first + n + 1)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _tool_trace(base, data):
    """trace_report over the cifar10 wali-gp Trainer's GGAN_PROFILE trace
    (a new step graph's warm-up and capture, then its replays, whose
    kernels are attributed to the graph launch and grouped as the
    warm-up's), held to profile_train's device ms of the graph; then SSGAN
    moving-MNIST local_ep f32's trace on the eager dispatch, whose top
    kernels name the convs they serve."""
    from graphical_gan_tpu_torch.tools import trace_report
    from graphical_gan_tpu_torch.tools.mfu import make_trainer
    from graphical_gan_tpu_torch.train.trainer import Trainer
    tr = Trainer(_published("float32"), data, os.path.join(base, "gan"),
                 seed=0, device="cuda", checkpoint_every=0)
    trace_dir = _trace_run(base, "gan_trace", tr, TOOL_PROFILE_START,
                           TOOL_PROFILE_ITERS)
    traced = trace_report.traced_iterations(trace_dir)
    rep = trace_report.report(trace_dir, iters=traced, top=8)
    dev_ms = trace_report.profile_train(tr, TOOL_PROFILE_ITERS)[1]
    rel = abs(rep["busy_ms_per_iter"] - dev_ms) / dev_ms
    log({"phase": "tools", "tool": "trace_report", "config":
         "cifar10 wali-gp f32", "traced_iterations": traced,
         **trace_report.summary_line(rep),
         "by_op_ms_per_iter": {g["group"]: g["ms_per_iter"]
                               for g in rep["by_op"]},
         "top_ops": rep["top_ops"],
         "profile_train_device_ms_per_iter": dev_ms, "rel_diff": rel})
    if rep["lanes"] != "device" or not rel <= TRACE_AGREE:
        fail(f"trace_report: {rep['busy_ms_per_iter']} device ms/iter "
             f"({rep['lanes']} lanes) against profile_train's {dev_ms}")
    tr = make_trainer("ssgan", "float32", os.path.join(base, "ssgan"),
                      "cuda", data_rows=200)
    # eager: its kernels keep the ops that launched them, which name the
    # convs (a replay's kernels have the graph launch alone)
    tr._eager = True
    trace_dir = _trace_run(base, "ssgan_trace", tr, 1, SSGAN_TRACE_ITERS)
    traced = trace_report.traced_iterations(trace_dir)
    rep = trace_report.report(trace_dir, iters=traced, top=8)
    log({"phase": "tools", "tool": "trace_report", "config":
         "ssgan moving-MNIST local_ep f32", "traced_iterations": traced,
         **trace_report.summary_line(rep),
         "by_op_ms_per_iter": {g["group"]: g["ms_per_iter"]
                               for g in rep["by_op"]},
         "top_ops": rep["top_ops"]})


def _tool_mfu():
    from graphical_gan_tpu_torch.tools import mfu
    for family, dtype in (("gan", "float32"), ("gan", "bfloat16"),
                          ("gmgan", "float32"), ("ssgan", "float32")):
        rec = mfu.measure(family, dtype, TOOL_ROUNDS, TOOL_ITERS, "cuda")
        log({"phase": "tools", "tool": "mfu", **rec})
        for key in ("mfu", "hbm_bw_util"):
            if rec[key] is None or not 0 < rec[key] <= 1:
                fail(f"mfu {family} {dtype}: {key} {rec[key]} outside "
                     f"(0, 1]")


def _tool_memory():
    import torch
    from graphical_gan_tpu_torch.tools import memory
    rec = memory.step_memory("float32", "gan", data_rows=1024,
                             device="cuda")
    total = torch.cuda.mem_get_info()[1]
    log({"phase": "tools", "tool": "memory", "family": "gan",
         "dtype": "float32", **rec, "hbm_budget_bytes": total})
    live = rec["state_bytes"] + rec["data_resident_bytes"]
    if not live < rec["peak_bytes"] <= total:
        fail(f"memory: peak {rec['peak_bytes']} not in ({live}, {total}]")


def _tool_determinism():
    from graphical_gan_tpu_torch.tools import determinism
    for family, dim, b, dataset in (("gan", 64, 64, "cifar10"),
                                    ("gmgan", REPLAY_DIM, REPLAY_B,
                                     "mnist")):
        results = determinism.run_all(family, dim, b, DET_CHUNK_ITERS,
                                      DET_TRAINER_ITERS, "cuda", dataset)
        for r in results:
            log({"phase": "tools", "tool": "determinism", "family": family,
                 "dataset": dataset, "dim": dim, "B": b, **r})
        bad = [r["check"] for r in results if not r["ok"]]
        if bad:
            fail(f"determinism {family}: {bad} not bit-identical")


def _tool_benches(base):
    from graphical_gan_tpu_torch.tools import (
        bench_families, bench_server, bench_serving)
    for name in ("gmgan", "ssgan", "ssgan_device"):
        rec = bench_families.bench(name, "bfloat16", TOOL_ROUNDS, TOOL_ITERS,
                                   "cuda")
        log({"phase": "tools", "tool": "bench_families", **rec})
    for family in ("gan_inference", "gmgan", "ssgan"):
        for rec in bench_serving.measure(family, (8, 256), SERVING_DEPTH,
                                         SERVING_ROUNDS, device="cuda"):
            log({"phase": "tools", "tool": "bench_serving", **rec})
    run_dir = bench_server.write_run_dir(os.path.join(base, "server_run"),
                                         "gan_inference")
    for n in (1, 8):
        rec = bench_server.run_load(run_dir, n, 8, SERVER_REQUESTS,
                                    (8, 64, 256), 5.0, "cuda")
        log({"phase": "tools", "tool": "bench_server", **rec})


def _gmgan_process_replay(base):
    """ROADMAP §3 fault 1: the final parameters of one GMGAN mnist local_ep
    Trainer run (published width, REPLAY_ITERS iterations, seed 42) in a
    fresh subprocess and in this process after every other phase, compared
    bit for bit. A reading, whichever way it falls."""
    import numpy as np
    from graphical_gan_tpu_torch.tools import determinism
    path = os.path.join(base, "gmgan_replay.npz")
    code = _REPLAY_CODE.format(root=ROOT, dim=REPLAY_DIM, b=REPLAY_B,
                               iters=REPLAY_ITERS, out=path)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"gmgan process replay subprocess: {res.stderr[-3000:]}")
    with np.load(path) as f:
        fresh = {k: f[k] for k in f.files}
    model, _, resident = determinism._build("gmgan", REPLAY_DIM, REPLAY_B,
                                            "mnist")
    here = determinism.trainer_params(model, resident, REPLAY_ITERS, "cuda")
    _log_replay("gmgan process replay", here, fresh)
    # the same run in a fresh subprocess while another process holds most
    # of the card's free memory (ROADMAP §3 fault 1: does the memory left
    # to cuDNN and the allocator change the bits?)
    import torch
    torch.cuda.empty_cache()
    holder = subprocess.Popen(
        [sys.executable, "-c", _HOLDER_CODE.format(share=HOLD_SHARE)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        held = holder.stdout.readline().strip()
        if not held.startswith("held"):
            fail(f"gmgan replay under memory pressure: the holder printed "
                 f"{held!r}")
        free = torch.cuda.mem_get_info()[0]
        path2 = os.path.join(base, "gmgan_replay_pressed.npz")
        res = subprocess.run(
            [sys.executable, "-c", _REPLAY_CODE.format(
                root=ROOT, dim=REPLAY_DIM, b=REPLAY_B, iters=REPLAY_ITERS,
                out=path2)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
    finally:
        holder.stdin.close()
        holder.wait(timeout=60)
    if res.returncode != 0:
        fail(f"gmgan replay under memory pressure: {res.stderr[-3000:]}")
    with np.load(path2) as f:
        pressed = {k: f[k] for k in f.files}
    _log_replay("gmgan process replay under memory pressure", pressed,
                fresh, held_bytes=int(held.split()[1]),
                free_bytes_while_held=int(free))


def _log_replay(check, got, fresh, **extra):
    """One replay reading: ``got``'s final parameters against the fresh
    subprocess run's, bit for bit."""
    import numpy as np
    differ = sorted(n for n in got
                    if not np.array_equal(got[n], fresh[n], equal_nan=True))
    log({"check": check, "iters": REPLAY_ITERS,
         "dim": REPLAY_DIM, "B": REPLAY_B,
         "bit_equal": not differ and sorted(got) == sorted(fresh),
         "differing_leaves": differ,
         "max_abs_diff": max((float(np.max(np.abs(got[n] - fresh[n])))
                              for n in differ), default=0.0), **extra})


def phase_tools(launch_totals, data):
    """Each measurement tool of graphical_gan_tpu_torch/tools on the card at
    published widths: trace_report (against profile_train), mfu (0 < mfu
    <= 1), memory, determinism (all five checks bit-identical for gan and
    gmgan), bench_families, bench_serving, bench_server; then the GMGAN
    process replay. ``launch_totals`` receives the kernels' launches. Each
    tool's seconds are logged."""
    from graphical_gan_tpu_torch.ops import kernels
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_tools")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    kernels.reset_launches()
    for name, fn, args in (("trace_report", _tool_trace, (base, data)),
                           ("mfu", _tool_mfu, ()),
                           ("memory", _tool_memory, ()),
                           ("determinism", _tool_determinism, ()),
                           ("benches", _tool_benches, (base,))):
        t0 = time.perf_counter()
        fn(*args)
        log({"tool_seconds": name,
             "seconds": round(time.perf_counter() - t0, 3)})
    launch_totals.update(kernels.launches())
    t0 = time.perf_counter()
    _gmgan_process_replay(base)
    log({"tool_seconds": "gmgan process replay",
         "seconds": round(time.perf_counter() - t0, 3)})


# ---------------------------------------------------------------------------
# the gradient penalty's inner pass: input gradients only (ROADMAP §3 fault
# 4), on the card, where autograd runs a CUDA node's backward on a device
# thread of its own unless the scope keeps it on the caller's

def phase_fault4(launch_totals):
    """One published cifar10 wali-gp f32 step on the card, plain, with
    ``remat`` and with ``fused_gp``, under a dispatch mode that records for
    each ``convolution_backward`` whether it ran inside the penalty's
    ``input_grads_only`` scope and whether it computed a weight gradient:
    the scope's calls must exist and compute none, and the step's other
    calls still compute the filters' gradients; then the FLOP count of
    ``tools/mfu.py`` at that config (the fault's 35.91e9 gone)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.ops.kernels import fused_conv
    from graphical_gan_tpu_torch.tools import mfu
    from graphical_gan_tpu_torch.train.step import make_train_step

    class Masks(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func.overloadpacket) == "aten.convolution_backward":
                self.calls.append((getattr(fused_conv._scope, "input_only",
                                           False), bool(args[10][1])))
            return func(*args, **(kwargs or {}))

    kernels.reset_launches()
    raw, _ = _parity_inputs(_option_model(), seed=9)
    misses = []
    for label, kw in (("plain", {}), ("remat", dict(remat=True)),
                      ("fused_gp", dict(fused_gp=True))):
        model = _option_model(**kw)
        step, init = make_train_step(model)
        st = init(model.init(seed=3, device="cuda"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(70)
        with Masks() as masks:
            st, met = step(st, raw[0].cuda(), True, gen)
            torch.cuda.synchronize()
        inner = [w for scoped, w in masks.calls if scoped]
        outer = [w for scoped, w in masks.calls if not scoped]
        ok = bool(inner) and not any(inner) and any(outer) and all(
            math.isfinite(float(v)) for v in met.values())
        log({"phase": "fault4", "step": label,
             "conv_backward_in_scope": len(inner),
             "weight_grads_in_scope": sum(inner),
             "conv_backward_outside": len(outer),
             "weight_grads_outside": sum(outer), "ok": ok})
        if not ok:
            misses.append(label)
    _add(launch_totals, kernels.launches())
    flops = mfu.flops_per_iter("float32", "gan")
    log({"phase": "fault4", "flops_per_iter": flops,
         "formerly_redundant_flops": FAULT4_REDUNDANT_FLOPS,
         "before": flops + FAULT4_REDUNDANT_FLOPS})
    if misses:
        fail(f"fault4: the penalty's inner pass computes weight gradients "
             f"or runs outside its scope on the card: {misses}")


# the conv items the penalty's inner pass ran before the repair at the
# published config, per iteration (tests/test_torch_flop_gap.py): 15 D.1, 15
# D.2 and 5 D.3 items of 2·B·Ho·Wo·Cin·Cout·25 FLOPs each
FAULT4_REDUNDANT_FLOPS = (15 * 2 * 64 * 16 * 16 * 3 * 64 * 25
                          + 15 * 2 * 64 * 8 * 8 * 64 * 128 * 25
                          + 5 * 2 * 64 * 4 * 4 * 128 * 256 * 25)


# ---------------------------------------------------------------------------
# phase-deconv: the stride-2 transposed conv as one stride-1 K1 conv plus a
# depth-to-space (ops/phase_deconv.py), against the cuDNN route

PHASE_TIME_ITERS = 2     # SSGAN iterations profiled per gate setting


def phase_conv_shapes():
    """(label, x shape, phase filter shape, pads) of K1's stride-1 phase
    conv at every shape of ``tools/bench_phase_deconv.py``."""
    import torch
    from graphical_gan_tpu_torch.ops.phase_deconv import _phase_kernel
    from graphical_gan_tpu_torch.tools.bench_phase_deconv import K, SHAPES
    out = []
    for label, b, h, cin, cout in SHAPES:
        big, (pl, pr) = _phase_kernel(torch.zeros((K, K, cout, cin)), K)
        out.append((f"phase {label}", (b, h, h, cin), tuple(big.shape),
                    ((pl, pr), (pl, pr))))
    return out


def _check_phase_convs(gen, errs, misses, seen):
    """K1 at the phase convs' shapes (stride 1, explicit window pads, Cout
    4·O), against its plain version; ``seen`` collects their routes."""
    import torch
    for dtype in (torch.float32, torch.bfloat16):
        for label, xs, ws, pads in phase_conv_shapes():
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = torch.randn(ws, generator=gen, device="cuda") * 0.05
            bias = torch.randn((ws[3],), generator=gen, device="cuda") * 0.1
            _check_conv(label, x, w, bias, 1, pads, None, errs, misses,
                        seen)


def _phase_route_check(label, b, h, cin, cout, dtype, gen, misses):
    """The phase route against the cuDNN route at one shape: the forward,
    dx and dw at one cotangent, at the K1 tolerances (``conv``,
    ``conv_bwd``); returns K1's launches in the phase route's forward and
    backward."""
    import torch
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.ops.conv import conv_transpose
    from graphical_gan_tpu_torch.ops.phase_deconv import (
        conv_transpose_phase)
    dn = str(dtype).split(".")[1]
    x = torch.randn((b, h, h, cin), generator=gen, device="cuda").to(dtype)
    w = torch.randn((5, 5, cout, cin), generator=gen, device="cuda") * 0.05
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    g = torch.randn((b, 2 * h, 2 * h, cout), generator=gen,
                    device="cuda").to(dtype)
    sides, launched = [], 0
    for fn in (conv_transpose_phase, conv_transpose):
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        before = kernels.launches()["fused_conv2d_bias_act"]
        y = fn(xl, wl, bias)
        dx, dw = torch.autograd.grad(y, (xl, wl), g)
        if fn is conv_transpose_phase:
            launched = kernels.launches()["fused_conv2d_bias_act"] - before
        sides.append((y.detach(), dx, dw))
    torch.cuda.synchronize()
    atol, rtol = TOL[("conv", dn)]
    e_fwd, bad = max_err(sides[0][0], sides[1][0], atol, rtol)
    atol_b, rtol_b = TOL[("conv_bwd", dn)]
    errs = {"fwd": e_fwd}
    for i, name in ((1, "dx"), (2, "dw")):
        ref = sides[1][i]
        e, miss = max_err(sides[0][i], ref, atol_b * max(1.0, float(
            ref.float().abs().max())), rtol_b)
        errs[name] = e
        bad |= miss
    ok = not bad and launched == 1 and sides[0][0].dtype == dtype
    log({"phase": "phase-deconv", "check": "phase route vs cudnn",
         "shape": label, "dtype": dn, "max_abs_err": errs,
         "tol": {"fwd": [atol, rtol], "bwd": [atol_b, rtol_b]},
         "k1_launches": launched, "ok": ok})
    if not ok:
        misses.append(f"{label} {dn}")


def _gate_readings(base):
    """Device ms of one SSGAN moving-MNIST local_ep f32 iteration (profiled
    over PHASE_TIME_ITERS) and of one f32 sampler dispatch at B 256
    (cifar10 wali-gp, CUDA events), with ``GGAN_PHASE_DECONV`` off and on;
    the two samplers' images agree within 1e-4."""
    import torch
    from graphical_gan_tpu_torch.tools import mfu
    from graphical_gan_tpu_torch.tools.trace_report import profile_train
    old = os.environ.get("GGAN_PHASE_DECONV")
    model = _published("float32")
    params = model.init(seed=4, device="cuda")
    noise = torch.randn((256, model.cfg.dim_latent), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
    images = {}
    try:
        for gate in ("0", "1"):
            os.environ["GGAN_PHASE_DECONV"] = gate
            tr = mfu.make_trainer("ssgan", "float32",
                                  os.path.join(base, f"ssgan_{gate}"),
                                  "cuda", data_rows=200)
            tr.step_fn(tr.state, tr.draw_batches(0), True, tr.generator)
            busy, dev_ms, groups = profile_train(tr, PHASE_TIME_ITERS)[:3]
            log({"phase": "phase-deconv", "reading": "ssgan iteration",
                 "config": "moving-MNIST local_ep f32", "gate": gate,
                 "device_ms_per_iter": dev_ms, "busy_share": busy,
                 "device_ms_per_iter_by_group": groups})
            with torch.inference_mode():
                images[gate] = model.sample(params, noise).float()
                ms = time_ms(lambda z: model.sample(params, z), (noise,))
            log({"phase": "phase-deconv", "reading": "sampler dispatch",
                 "config": "cifar10 wali-gp f32", "B": 256, "gate": gate,
                 "device_ms": ms})
    finally:
        if old is None:
            os.environ.pop("GGAN_PHASE_DECONV", None)
        else:
            os.environ["GGAN_PHASE_DECONV"] = old
    diff = float((images["0"] - images["1"]).abs().max())
    log({"phase": "phase-deconv", "check": "sampler gate off vs on",
         "max_abs_diff": diff, "ok": diff <= 1e-4})
    if not diff <= 1e-4:
        fail(f"phase-deconv: the sampler's images differ by {diff} between "
             "the routes")


def phase_phase_deconv(launch_totals):
    """The phase route against the cuDNN route at the eight bench shapes
    (forward, dx, dw; f32 and bf16; K1's launches counted), the bench tool
    on the card, and the SSGAN iteration and f32 sampler with the gate off
    and on."""
    import torch
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.tools import bench_phase_deconv
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_phase")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    misses = []
    kernels.reset_launches()
    for label, b, h, cin, cout in bench_phase_deconv.SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _phase_route_check(label, b, h, cin, cout, dtype, gen, misses)
    launch_totals.update(kernels.launches())
    if misses:
        fail(f"phase-deconv: the phase route disagrees with cuDNN's or does "
             f"not run K1: {misses}")
    for rec in bench_phase_deconv.main([]):
        log({"phase": "phase-deconv", "tool": "bench_phase_deconv", **rec})
    # the tool's --k: 3x3 transpose filters at two shapes
    recs = bench_phase_deconv.main(["--k", "3", "--shapes", "gen2,ss3",
                                    "--dtype", "bfloat16"])
    for rec in recs:
        log({"phase": "phase-deconv", "tool": "bench_phase_deconv", **rec})
    if [r["k"] for r in recs] != [3] * 4:
        fail(f"bench_phase_deconv --k 3: {[r['k'] for r in recs]}")
    _gate_readings(base)


# ---------------------------------------------------------------------------
# failure: SIGTERM, rollback, async checkpoints and the kernel build cache
# through the real CLI, at the published cifar10 wali-gp config

# 100 before the frozen-inception phase took that time
FAIL_ITERS = 60
FAIL_CKPT_EVERY = 50
# the SIGTERM drill's dispatches: at the default chunk size iterations 5-49
# are one dispatch, which a SIGTERM cannot cut before the periodic ckpt_49
FAIL_CHUNK = 4
FAIL_NAN_AT = 7
SAVE_REPS = 3
_NVCC_WRAPPER = """#!/bin/sh
echo "$@" >> {log}
exec {nvcc} "$@"
"""


def _cli(run_dir, cache, *extra):
    return [sys.executable, "-m", "graphical_gan_tpu_torch.runs.gan_inference",
            "--dataset", "cifar10", "--mode", "wali-gp",
            "--iters", str(FAIL_ITERS), "--checkpoint-every",
            str(FAIL_CKPT_EVERY), "--compile-cache", cache, "--run-dir",
            run_dir, *extra]


def _run_cli(cmd, env, sigterm_after=None):
    """(exit code, output, seconds to the iteration-0 line, seconds from
    the SIGTERM to the exit or None): ``sigterm_after`` sends SIGTERM that
    many seconds after the iteration-4 line."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, first, stop = [], None, None
    try:
        for line in proc.stdout:
            lines.append(line)
            if first is None and line.startswith("iter 0\t"):
                first = time.perf_counter() - t0
            if sigterm_after is not None and stop is None \
                    and line.startswith("iter 4\t"):
                time.sleep(sigterm_after)
                proc.send_signal(signal.SIGTERM)
                stop = time.perf_counter()
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    exit_s = None if stop is None else time.perf_counter() - stop
    return proc.returncode, "".join(lines), first, exit_s


def _ckpt_equal(a, b):
    """The keys whose arrays differ between two npz checkpoints (all keys
    where the key sets differ)."""
    import numpy as np
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
    fa, ea = ckpt_lib.load_raw(a)
    fb, eb = ckpt_lib.load_raw(b)
    if set(fa) != set(fb):
        return sorted(set(fa) ^ set(fb))
    return sorted(k for k in fa if not np.array_equal(fa[k], fb[k]))


def _preempted(text):
    """The iterations the ``preempted:`` lines of a run's output name."""
    return [int(ln.split("iteration ")[1].split(";")[0])
            for ln in text.splitlines() if ln.startswith("preempted:")]


def _costs(text):
    return [float(ln.split("train disc cost\t")[1].split("\t")[0])
            for ln in text.splitlines()
            if ln.startswith("iter ") and "train disc cost\t" in ln]


def _save_times(base, data):
    """Median ms that ``Trainer.save`` holds the loop at the published f32
    state (78.9 MB), synchronous against async, and the async write's
    time to disk; the two files' arrays equal."""
    import torch
    from graphical_gan_tpu_torch.train.trainer import Trainer
    out = {}
    for mode in ("sync", "async"):
        tr = Trainer(_published("float32"), data[:1024],
                     os.path.join(base, f"save_{mode}"), seed=0,
                     device="cuda", checkpoint_every=0,
                     async_checkpoint=mode == "async",
                     checkpoints_to_keep=0)
        tr.state = tr.init_state(tr.model.init(0, tr.device))
        held, done = [], []
        for i in range(SAVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.save(i)
            held.append((time.perf_counter() - t0) * 1e3)
            if tr._ckpt_writer is not None:
                tr._ckpt_writer.join()
            done.append((time.perf_counter() - t0) * 1e3)
        out[mode] = (statistics.median(held), statistics.median(done),
                     os.path.join(tr.outf, "ckpt_0.npz"))
    differ = _ckpt_equal(out["sync"][2], out["async"][2])
    nbytes = os.path.getsize(out["sync"][2])
    log({"phase": "failure", "reading": "save", "file_bytes": nbytes,
         "sync_ms_held": out["sync"][0], "async_ms_held": out["async"][0],
         "async_ms_to_disk": out["async"][1], "arrays_equal": not differ})
    if differ:
        fail(f"failure: an async save's arrays differ from a sync one's: "
             f"{differ[:5]}")


def phase_failure(data):
    """The failure drills through ``runs/gan_inference.py`` in subprocesses
    at the published cifar10 wali-gp config (B 64, DIM 64, k 5, f32) on the
    loader's synthetic data, ``--iters 60 --checkpoint-every 50``, each
    run with ``--compile-cache`` on one directory, ``nvcc`` wrapped so its
    calls are logged:

    1. an uninterrupted run, the first into the empty cache: it builds;
    2. a run at ``--chunk-size 4`` sent SIGTERM one second after its
       iteration-4 line: exit 0, one ``preempted`` line naming an
       iteration below 49 (a mid-run checkpoint, not the periodic one), no
       ``nvcc`` call (the cache loads); resumed with ``--run-dir`` at the
       same chunk size to iteration 60, its ckpt_59 equals run 1's bit for
       bit; then the same SIGTERM to a run at the default chunk size (a
       reading: its stop waits for the dispatch 5-49);
    3. ``GGAN_FAULT_NAN_AT=7 --max-rollbacks 1``: one ``rollback 1/1``
       line, finite costs and checkpoint, ``rng_salt_high`` 1;
    4. ``GGAN_FAULT_NAN_AT=7`` without the guard and with
       ``GGAN_ASYNC_CKPT=1``: no rollback, the window of iteration 7 logged
       as nan, and
       ckpt_49 and ckpt_99 equal run 1's bit for bit (the injection is
       inert, and async checkpoints equal sync ones);

    then in this process the time ``save`` holds the loop, sync against
    async. Logs each run's seconds to its first iteration (the cold build
    against the cached load) and the SIGTERM's stop-to-exit seconds."""
    import numpy as np
    from graphical_gan_tpu_torch.ops.kernels import build
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_failure")
    shutil.rmtree(base, ignore_errors=True)
    cache = os.path.join(base, "cache")
    bindir = os.path.join(base, "bin")
    os.makedirs(cache)
    os.makedirs(bindir)
    nvcc_log = os.path.join(base, "nvcc.log")
    open(nvcc_log, "w").close()
    wrapper = os.path.join(bindir, "nvcc")
    with open(wrapper, "w") as f:
        f.write(_NVCC_WRAPPER.format(log=nvcc_log, nvcc=build.nvcc_path()))
    os.chmod(wrapper, 0o755)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"],
               PYTHONUNBUFFERED="1")
    for k in ("GGAN_FAULT_NAN_AT", "GGAN_ASYNC_CKPT", "GGAN_PHASE_DECONV",
              "GGAN_PROFILE", "GGAN_COMPILE_CACHE"):
        env.pop(k, None)

    def nvcc_calls():
        with open(nvcc_log) as f:
            return f.read().splitlines()

    run = {k: os.path.join(base, k) for k in ("straight", "cut",
                                               "cut_default", "rollback",
                                               "inert")}
    misses = []
    rc, out, first_cold, _ = _run_cli(_cli(run["straight"], cache), env)
    built = nvcc_calls()
    log({"phase": "failure", "run": "straight", "rc": rc,
         "seconds_to_iter_0": first_cold, "nvcc_calls": len(built),
         "cache_entries": sorted(os.listdir(cache))})
    if rc != 0 or not built or len(_costs(out)) < 6:
        fail(f"failure: the uninterrupted run (rc {rc}, {len(built)} nvcc "
             f"calls): {out[-3000:]}")

    chunk = ("--chunk-size", str(FAIL_CHUNK))
    rc, out, first_cached, exit_s = _run_cli(
        _cli(run["cut"], cache, *chunk), env, sigterm_after=1.0)
    stopped = _preempted(out)
    cached_clean = nvcc_calls() == built
    log({"phase": "failure", "run": "sigterm", "chunk_size": FAIL_CHUNK,
         "rc": rc, "seconds_to_iter_0": first_cached,
         "sigterm_stop_to_exit_s": exit_s, "preempted_at": stopped,
         "nvcc_calls_after_cold_build": len(nvcc_calls()) - len(built)})
    if rc != 0 or len(stopped) != 1 or stopped[0] >= FAIL_CKPT_EVERY - 1:
        misses.append(f"SIGTERM: rc {rc}, preempted at {stopped}")
    if not cached_clean:
        misses.append("the cached library ran nvcc again")
    rc2, out2, _, _ = _run_cli(_cli(run["cut"], cache, *chunk), env)
    final = os.path.join(run["cut"], f"ckpt_{FAIL_ITERS - 1}.npz")
    differ = (_ckpt_equal(os.path.join(run["straight"],
                                       f"ckpt_{FAIL_ITERS - 1}.npz"), final)
              if rc2 == 0 and os.path.exists(final) else ["no final ckpt"])
    log({"phase": "failure", "run": "sigterm resume", "rc": rc2,
         "final_state_bit_identical": not differ,
         "differing_leaves": differ[:5]})
    if rc2 != 0 or differ:
        misses.append(f"SIGTERM resume: rc {rc2}, differing {differ[:5]}")
    rc, out, _, exit_s = _run_cli(_cli(run["cut_default"], cache), env,
                                  sigterm_after=1.0)
    stopped = _preempted(out)
    log({"phase": "failure", "run": "sigterm", "chunk_size": None,
         "rc": rc, "sigterm_stop_to_exit_s": exit_s,
         "preempted_at": stopped})
    if rc != 0 or len(stopped) != 1:
        misses.append(f"SIGTERM at the default chunk size: rc {rc}, "
                      f"preempted at {stopped}")

    nan_env = dict(env, GGAN_FAULT_NAN_AT=str(FAIL_NAN_AT))
    rc, out, _, _ = _run_cli(_cli(run["rollback"], cache, "--max-rollbacks",
                                  "1"), nan_env)
    rollbacks = [ln for ln in out.splitlines() if "rollback 1/1" in ln]
    last = ckpt_lib.latest(run["rollback"])
    extra = ckpt_lib.load_raw(last)[1] if last else {}
    flat = ckpt_lib.load_raw(last)[0] if last else {}
    finite = bool(flat) and all(np.isfinite(a).all() for a in flat.values()
                                if np.issubdtype(a.dtype, np.floating))
    costs = _costs(out)
    log({"phase": "failure", "run": "rollback", "rc": rc,
         "rollback_lines": rollbacks, "last_checkpoint":
         os.path.basename(last or ""), "rng_salt": extra.get("rng_salt"),
         "rng_salt_high": extra.get("rng_salt_high"),
         "checkpoint_finite": finite, "last_costs": costs[-3:]})
    if (rc != 0 or len(rollbacks) != 1 or extra.get("rng_salt_high") != 1
            or not finite or not costs
            or not all(math.isfinite(c) for c in costs[-3:])):
        misses.append(f"rollback: rc {rc}, lines {rollbacks}, extra {extra}")

    rc, out, _, _ = _run_cli(_cli(run["inert"], cache), dict(
        nan_env, GGAN_ASYNC_CKPT="1"))
    # the flush after iteration 7 logs the window's mean cost: nan
    nan_logged = any(ln.startswith("iter ") and int(ln.split("\t")[0][5:])
                     >= FAIL_NAN_AT and "train disc cost\tnan" in ln
                     for ln in out.splitlines())
    differ = {}
    for it in (FAIL_CKPT_EVERY - 1, FAIL_ITERS - 1):
        name = f"ckpt_{it}.npz"
        got = os.path.join(run["inert"], name)
        differ[name] = (_ckpt_equal(os.path.join(run["straight"], name), got)
                        if os.path.exists(got) else ["missing"])
    log({"phase": "failure", "run": "inert + async", "rc": rc,
         "nan_logged": nan_logged,
         "rollback_lines": sum("divergence guard" in ln
                               for ln in out.splitlines()),
         "checkpoints_bit_identical_to_sync": {
             k: not v for k, v in differ.items()}})
    if rc != 0 or not nan_logged or any(differ.values()) \
            or "divergence guard" in out:
        misses.append(f"inert/async: rc {rc}, nan logged {nan_logged}, "
                      f"differing {differ}")
    _save_times(base, data)
    if misses:
        fail(f"failure: {misses}")


# ---------------------------------------------------------------------------
# int8-export: int8 serving (ops/quant.py) on Q1 and Q2 (csrc/quant.cu) at
# the published samplers, and the run directory's torch.export artifacts

INT8_CALIB_B = 64       # the calibration batch of the phase's samplers
INT8_E2E_B = 8          # rows of the card-against-CPU sampler check
# tests/test_torch_quant_sampler.py's bound: no int8 value flips between
# the two runs, and the outputs (in [-1, 1]) differ by f32 roundings
INT8_E2E_ATOL = 1e-6
INT8_DISPATCH_BUCKETS = (8, 256)


def _int8_models(dtype):
    """The three published samplers of the int8 checks: cifar10 wali-gp
    (DIM 64, z 128), GMGAN mnist local_ep (DIM 64, 30 components) and
    SSGAN moving-MNIST local_ep (DIM 32, LEN 16)."""
    from graphical_gan_tpu_torch.core.config import gmgan_defaults
    from graphical_gan_tpu_torch.models.gmgan import GMGanModel
    gm = GMGanModel(gmgan_defaults("mnist", "local_ep",
                                   compute_dtype=dtype))
    if (gm.cfg.dim_g or gm.cfg.dim, gm.cfg.n_coms) != (64, 30):
        fail(f"gmgan mnist defaults changed: {gm.cfg}")
    return (("gan_inference", _published(dtype)), ("gmgan", gm),
            ("ssgan", _ssgan_model("moving_mnist", "local_ep",
                                   compute_dtype=dtype)))


class _Int8Calls:
    """Records every standalone Q1, Q2 and dual-output K2b call the int8
    layers make (their arguments; K2b's with its outputs) while it is
    entered; each Q2 call also with the transposed conv's k where a deconv
    made it (on its phase filter), else None."""

    def __init__(self):
        self.q1, self.q2, self.k2b = [], [], []
        self._deconv_k = None

    def __enter__(self):
        from graphical_gan_tpu_torch.ops import norm, quant
        from graphical_gan_tpu_torch.ops.kernels import fused_norm
        self._mods = (quant, norm)
        self._saved = (quant.quantize_int8, quant.int8_conv_packed,
                       quant.intercept_deconv2d, norm.batchnorm_act_q8)
        q1, q2, deconv, bn_q8 = self._saved

        def rec_q1(x, scale, axis=None):
            self.q1.append((x, scale, axis))
            return q1(x, scale, axis)

        def rec_q2(xq, pf, factor, stride=1, padding="VALID",
                   out_dtype=None, bias=None, act=None):
            self.q2.append((xq, pf, factor, stride, padding, out_dtype,
                            bias, act, self._deconv_k))
            return q2(xq, pf, factor, stride, padding, out_dtype, bias, act)

        def rec_deconv(name, x, w, stride, padding, bias=None):
            self._deconv_k = int(w.shape[0])
            try:
                return deconv(name, x, w, stride, padding, bias)
            finally:
                self._deconv_k = None

        def rec_bn_q8(x, scale, offset, act, s_x, eps=fused_norm.EPS):
            # K2b's arguments: its statistics again (K2a gives the same
            # bits every call)
            y, q = bn_q8(x, scale, offset, act, s_x, eps)
            x2d = x.reshape(-1, x.shape[-1])
            mean, _, inv = fused_norm.bn_stats(x2d, eps)
            self.k2b.append((x2d, mean, inv, scale, offset, act, s_x,
                             y.reshape(x2d.shape), q.reshape(x2d.shape)))
            return y, q
        (quant.quantize_int8, quant.int8_conv_packed,
         quant.intercept_deconv2d, norm.batchnorm_act_q8) = (
            rec_q1, rec_q2, rec_deconv, rec_bn_q8)
        return self

    def __exit__(self, *exc):
        quant, norm = self._mods
        (quant.quantize_int8, quant.int8_conv_packed,
         quant.intercept_deconv2d, norm.batchnorm_act_q8) = self._saved


def _bits(t):
    """An integer view of a tensor's bits, for bit-for-bit equality."""
    import torch
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def _same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _check_q1(x, scale, axis, misses, label):
    """Q1 twice (one launch each, the same bits) against its plain version
    on the card; returns the largest difference of the int8 values."""
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    n0 = kq.quantize_int8.launches
    a = kq.quantize_int8(x, scale, axis)
    b = kq.quantize_int8(x, scale, axis)
    want = kq.quantize_int8_plain(x, scale, axis)
    if kq.quantize_int8.launches - n0 != 2:
        misses.append(f"{label}: Q1 counted "
                      f"{kq.quantize_int8.launches - n0} launches for 2")
    if not _same_bits(a, b):
        misses.append(f"{label}: Q1 differs between two calls")
    if not _same_bits(a, want):
        misses.append(f"{label}: Q1 != plain")
    return int((a.int() - want.int()).abs().max()) if a.numel() else 0


def _q2_plan_of(xq, pf, stride, pads):
    """``q2_plan``'s plan of a Q2 call as its CUDA op makes it."""
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    from graphical_gan_tpu_torch.ops.kernels.fused_conv import _pads
    explicit = _pads(xq.shape[1], xq.shape[2], pf.kh, pf.kw, stride,
                     kq.explicit_pads(pads))
    aligned = xq.data_ptr() % 16 == 0 and pf.wk.data_ptr() % 16 == 0
    return kq.q2_plan(tuple(xq.shape), pf.kh, pf.kw, pf.cout, stride,
                      explicit, aligned)


def _check_q2(xq, pf, factor, stride, pads, out_dtype, bias, act, misses,
              label):
    """Q2's int32 sums and its output (with the call's bias and
    activation), each twice, against the plain version (F.conv2d in f64,
    exact, then the epilogue's steps) on the card, each launch counted on
    the route ``q2_plan`` names; returns the largest difference of the sums
    and of the outputs, and that route."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    route = _q2_plan_of(xq, pf, stride, pads).route
    n0, r0 = kq.int8_conv.launches, kq.int8_conv.routes[route]
    s1 = kq.int8_conv_packed(xq, pf, None, stride, pads, torch.int32)
    s2 = kq.int8_conv_packed(xq, pf, None, stride, pads, torch.int32)
    y1 = kq.int8_conv_packed(xq, pf, factor, stride, pads, out_dtype, bias,
                             act)
    y2 = kq.int8_conv_packed(xq, pf, factor, stride, pads, out_dtype, bias,
                             act)
    sums = kq.int8_conv_sums_plain(xq, kq.unpack_filter(pf), stride, pads)
    want = kq.bias_act_plain(kq.dequantize_plain(sums, factor, out_dtype),
                             bias, act)
    if (kq.int8_conv.launches - n0, kq.int8_conv.routes[route] - r0) \
            != (4, 4):
        misses.append(f"{label}: Q2 counted {kq.int8_conv.launches - n0} "
                      f"launches, {kq.int8_conv.routes[route] - r0} on its "
                      f"route {route}, for 4")
    if not (_same_bits(s1, s2) and _same_bits(y1, y2)):
        misses.append(f"{label}: Q2 differs between two calls")
    if not _same_bits(s1, sums):
        misses.append(f"{label}: Q2 sums != plain")
    if not _same_bits(y1, want):
        misses.append(f"{label}: Q2 output != plain")
    return (int((s1.long() - sums.long()).abs().max()),
            float((y1.float() - want.float()).abs().max()), route)


def _check_k2b_q8(x2d, mean, inv, scale, offset, act, s_x, misses, label):
    """K2b with its int8 copy, twice: y bit-equal to K2b's alone, q equal
    to Q1's plain version of that y (and of the plain version's y, which
    K2b's own check holds within rounding); returns the largest difference
    of the int8 values and whether the whole plain version matched."""
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as kn
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    n0 = kn.bn_apply_q8.launches
    y1, q1 = kn.bn_apply_q8(x2d, mean, inv, scale, offset, act, s_x)
    y2, q2 = kn.bn_apply_q8(x2d, mean, inv, scale, offset, act, s_x)
    y0 = kn.bn_apply(x2d, mean, inv, scale, offset, act)
    want = kq.quantize_int8_plain(y1, s_x)
    py, pq = kn.bn_apply_q8_plain(x2d, mean, inv, scale, offset, act, s_x)
    if kn.bn_apply_q8.launches - n0 != 2:
        misses.append(f"{label}: K2b+Q1 counted "
                      f"{kn.bn_apply_q8.launches - n0} launches for 2")
    if not (_same_bits(y1, y2) and _same_bits(q1, q2)):
        misses.append(f"{label}: K2b+Q1 differs between two calls")
    if not _same_bits(y1, y0):
        misses.append(f"{label}: K2b+Q1's y != K2b's")
    if not _same_bits(q1, want):
        misses.append(f"{label}: K2b+Q1's int8 copy != Q1 of its y")
    return (int((q1.int() - want.int()).abs().max()),
            _same_bits(y1, py) and _same_bits(q1, pq))


def _q2_key(xq, pf, stride, pads, out_dtype):
    return (tuple(xq.shape), pf.hwio_shape, stride, tuple(pads)
            if not isinstance(pads, str) else pads, str(out_dtype))


def _in_taps(n_out, n_in, stride, lo, offsets):
    """Window taps of one axis that read inside the input, summed over the
    ``n_out`` outputs: ``offsets`` are the window positions taken."""
    return sum(1 for o in range(n_out) for t in offsets
               if 0 <= o * stride - lo + t < n_in)


def _q2_products(bsz, h, w, cin, cout, kh, kw, stride, lo_h, lo_w, oh, ow,
                 deconv_k):
    """The int8 products Q2's function needs, 2 ops each: for a conv the
    taps inside the input; for a deconv's phase filter (``deconv_k`` its
    k, T x T window, 4·O channels) only the taps of each output phase
    that the transposed conv has (``phase_deconv._phase_plan``; the
    filter's other taps are fixed zeros), inside the input: the transposed
    conv's own count."""
    if deconv_k is None:
        return 2.0 * bsz * _in_taps(oh, h, stride, lo_h, range(kh)) \
            * _in_taps(ow, w, stride, lo_w, range(kw)) * cin * cout
    from graphical_gan_tpu_torch.ops.phase_deconv import _phase_plan
    taps = _phase_plan(deconv_k)[3]
    per_phase = [[j for j, _ in taps[a]] for a in (0, 1)]
    return 2.0 * bsz * cin * (cout // 4) * sum(
        _in_taps(oh, h, 1, lo_h, per_phase[a])
        * _in_taps(ow, w, 1, lo_w, per_phase[c])
        for a in (0, 1) for c in (0, 1))


def _q2_row(xq, pf, factor, stride, pads, out_dtype, bias, act, deconv_k,
            family, b, card):
    """Q2's time at one shape (with the call's bias and activation in its
    epilogue) on ``q2_plan``'s route beside its plain version's and its
    bound (the products its function needs, :func:`_q2_products`, over
    the int8 peak, or bytes over the HBM rate); the linear shapes add
    torch._int_mm where it takes the shape (the library call); at the
    cifar10 sampler's shapes also the ``mma`` route (``mma_ms``) and, at
    its convs, cuDNN's f32 and bf16 conv of the same shape as readings."""
    import torch
    import torch.nn.functional as F
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    from graphical_gan_tpu_torch.ops.kernels.fused_conv import _pads
    bsz, h, w, cin = xq.shape
    kh, kw, cout = pf.kh, pf.kw, pf.cout
    (plo, phi), (qlo, qhi) = _pads(h, w, kh, kw, stride,
                                   kq.explicit_pads(pads))
    oh = (h + plo + phi - kh) // stride + 1
    ow = (w + qlo + qhi - kw) // stride + 1
    ops = _q2_products(bsz, h, w, cin, cout, kh, kw, stride, plo, qlo, oh,
                       ow, deconv_k)
    esize = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (xq.numel() + kh * kw * cin * cout + 4 * cout
              + (0 if bias is None else cout * esize)
              + bsz * oh * ow * cout * esize)
    t_ops, t_bytes = ops / card_peaks()[0]["int8"] * 1e3, hbm_ms(nbytes)
    plan = _q2_plan_of(xq, pf, stride, pads)
    ms = time_ms(lambda a, wk: kq.int8_conv_packed(
        a, pf._replace(wk=wk), factor, stride, pads, out_dtype, bias, act),
        [xq, pf.wk], 5, 10)
    # the mma route, and the plain version (F.conv2d in f64), at the
    # summary's sampler only
    main = family == "gan_inference"
    mma_ms = None
    if main and plan.route != "mma":
        mma = kq.q2_plan(tuple(xq.shape), kh, kw, cout, stride,
                         ((plo, phi), (qlo, qhi)), route="mma")
        mma_ms = time_ms(lambda a, wk: kq.run_plan(
            a, wk, factor, bias, kh, kw, cout, stride,
            ((plo, phi), (qlo, qhi)), out_dtype, act, mma), [xq, pf.wk],
            5, 10)
    wq = kq.unpack_filter(pf)
    plain_ms = time_ms(lambda a, b_: kq.int8_conv_plain(
        a, b_, factor, stride, pads, out_dtype, bias, act), [xq, wq], 3, 3) \
        if main and (b, out_dtype) == (256, torch.float32) else None
    row = {"kernel": "int8_conv", "family": family, "B": b,
           "dtype": str(out_dtype).replace("torch.", ""),
           "shape": [list(xq.shape), list(wq.shape), stride,
                     pads if isinstance(pads, str) else list(pads)],
           "deconv_k": deconv_k, "bias": bias is not None, "act": act,
           "route": plan.route,
           "plan": {k: v for k, v in plan.as_dict().items()
                    if k in ("bm", "bn", "bk", "stages", "splits")},
           "ms": ms, "mma_ms": mma_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None, "card": card}
    if kh == kw == h == w == 1:  # a dense layer: [M, K] @ [K, N]
        a2 = xq.reshape(bsz, cin)
        b2 = wq.reshape(cin, cout)
        if bsz > 16 and cin % 8 == 0 and cout % 8 == 0:
            try:
                row["library_ms"] = time_ms(torch._int_mm, [a2, b2], 5, 10)
            except RuntimeError as e:
                row["int_mm_refused"] = str(e).splitlines()[0]
        else:
            row["int_mm_refused"] = "M <= 16 or K, N not multiples of 8"
    elif main:
        xf = xq.permute(0, 3, 1, 2).float().contiguous(
            memory_format=torch.channels_last)
        wf = wq.permute(3, 2, 0, 1).float().contiguous(
            memory_format=torch.channels_last)
        for dn, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            xd, wd = xf.to(dt), wf.to(dt)
            row[f"cudnn_{dn}_conv_ms"] = time_ms(
                lambda a, b_: F.conv2d(F.pad(a, (qlo, qhi, plo, phi)), b_,
                                       stride=stride), [xd, wd], 5, 10)
    return row


def _q1_row(x, scale, axis, family, b, card):
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    nbytes = x.numel() * (x.element_size() + 1)
    return {"kernel": "quantize_int8", "family": family, "B": b,
            "dtype": str(x.dtype).replace("torch.", ""),
            "shape": list(x.shape), "per_channel": axis is not None,
            "ms": time_ms(lambda t: kq.quantize_int8(t, scale, axis), [x],
                          5, 10),
            "plain_ms": time_ms(lambda t: kq.quantize_int8_plain(
                t, scale, axis), [x], 5, 10),
            "bound_ms": hbm_ms(nbytes), "bound_by": "bytes",
            "library_ms": None, "card": card}


def _k2b_q8_row(x2d, mean, inv, scale, offset, act, s_x, family, b, card):
    """K2b with its int8 copy at one BN shape beside K2b alone (``k2b_ms``,
    the same inputs) and Q1 alone on K2b's output (``q1_ms``): the pass it
    saves; bound by its bytes (x read, y and q written, the four channel
    vectors)."""
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as kn
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    y = kn.bn_apply(x2d, mean, inv, scale, offset, act)
    nbytes = x2d.numel() * (2 * x2d.element_size() + 1) + 16 * x2d.shape[1]
    vecs = [mean, inv, scale, offset]
    return {"kernel": "bn_apply_q8", "family": family, "B": b,
            "dtype": str(x2d.dtype).replace("torch.", ""),
            "shape": list(x2d.shape), "act": act,
            "ms": time_ms(lambda t, *v: kn.bn_apply_q8(t, *v, act, s_x),
                          [x2d] + vecs, 5, 10),
            "k2b_ms": time_ms(lambda t, *v: kn.bn_apply(t, *v, act),
                              [x2d] + vecs, 5, 10),
            "q1_ms": time_ms(lambda t: kq.quantize_int8(t, s_x), [y], 5, 10),
            "plain_ms": time_ms(lambda t, *v: kn.bn_apply_q8_plain(
                t, *v, act, s_x), [x2d] + vecs, 5, 10),
            "bound_ms": hbm_ms(nbytes), "bound_by": "bytes",
            "library_ms": None, "card": card}


def _int8_sampler_checks(card, timings, misses):
    """Q1, Q2 and K2b's int8 copy at every int8 layer of the three
    published samplers, at buckets 8, 64 and 256, in f32 and bf16 (the
    first bucket's call fills the weight cache and pairs each BN with the
    layer it feeds; the later ones take K2b's int8 copies): each recorded
    call replayed twice against its plain version; Q2 timed at every
    shape, Q1 and K2b's int8 copy at the cifar10 sampler's. Returns the
    largest errors, the calls checked and Q2's calls per route."""
    import torch
    from graphical_gan_tpu_torch.serve.export import make_sampler
    from graphical_gan_tpu_torch.serve.quantize import (
        calibrate, prior_inputs, quantized_entry)
    err = {"q1": 0, "q2_sums": 0, "q2_out": 0.0, "k2b_q8": 0}
    checked = {"q1_calls": 0, "q2_calls": 0, "k2b_q8_calls": 0,
               "k2b_q8_whole_plain_equal": 0,
               "q2_routes": {"tma": 0, "mma": 0}}
    timed = set()
    for dtype in ("float32", "bfloat16"):
        for family, model in _int8_models(dtype):
            params = model.init(0, "cuda")
            scales = calibrate(family, model, params, 11, n_batches=1,
                               batch_size=INT8_CALIB_B)
            fn = quantized_entry(make_sampler(family, model)[0], scales)
            for b in BUCKETS:
                z = [torch.from_numpy(a).cuda()
                     for a in prior_inputs(family, model.cfg, b, 5)]
                if family == "gan_inference":
                    # G runs in its codes' dtype: bf16 codes for the bf16
                    # model, as the dispatch below feeds it
                    z = [t.to(getattr(torch, dtype)) for t in z]
                with _Int8Calls() as calls, torch.inference_mode():
                    fn(params, 3, *z)
                label = f"int8 {family} {dtype} B={b}"
                # the summary's dispatch: the f32 cifar10 sampler at B 256
                summary = (family, b, dtype) == ("gan_inference", 256,
                                                 "float32")
                with torch.inference_mode():
                    for x, scale, axis in calls.q1:
                        err["q1"] = max(err["q1"], _check_q1(
                            x, scale, axis, misses, label))
                        checked["q1_calls"] += 1
                        if summary:
                            timings.append(_q1_row(x, scale, axis, family,
                                                   b, card))
                    for x2d, mean, inv, sc, of, act, s_x, _, _ in calls.k2b:
                        e, whole = _check_k2b_q8(x2d, mean, inv, sc, of, act,
                                                 s_x, misses, label)
                        err["k2b_q8"] = max(err["k2b_q8"], e)
                        checked["k2b_q8_calls"] += 1
                        checked["k2b_q8_whole_plain_equal"] += int(whole)
                        if summary:
                            timings.append(_k2b_q8_row(
                                x2d, mean, inv, sc, of, act, s_x, family, b,
                                card))
                    for (xq, pf, factor, stride, pads, out, bias, act,
                         dk) in calls.q2:
                        s, y, route = _check_q2(xq, pf, factor, stride, pads,
                                                out, bias, act, misses,
                                                label)
                        err["q2_sums"] = max(err["q2_sums"], s)
                        err["q2_out"] = max(err["q2_out"], y)
                        checked["q2_calls"] += 1
                        checked["q2_routes"][route] += 1
                        key = (family, b) + _q2_key(xq, pf, stride, pads,
                                                    out)
                        if b in INT8_DISPATCH_BUCKETS and key not in timed:
                            # SSGAN's chain repeats shapes
                            timed.add(key)
                            timings.append(_q2_row(
                                xq, pf, factor, stride, pads, out, bias, act,
                                dk, family, b, card))
            del params
    return err, checked


def _int8_e2e(misses):
    """The quantized samplers at INT8_E2E_B rows in f32 on the card against
    the same on the CPU: the same params, scales, inputs and (SSGAN) chain
    eps, each called twice with one weight cache (the first call pairs
    each BN with the layer it feeds; the second takes K2b's int8 copies);
    per call the int8 activations compared per layer (Q1's, and the K2b
    copies), held to no flip, and the outputs to INT8_E2E_ATOL, as the CPU
    test holds the port to JAX."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.ops import quant
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    from graphical_gan_tpu_torch.serve.quantize import (
        calibrate, prior_inputs)
    out = []
    for family, model in _int8_models("float32"):
        params = model.init(0, "cuda")
        scales = calibrate(family, model, params, 11, n_batches=1,
                           batch_size=INT8_CALIB_B)
        inputs = prior_inputs(family, model.cfg, INT8_E2E_B, 5)
        eps = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (INT8_E2E_B, getattr(model.cfg, "dim_latent_t", 1)),
            dtype=np.float32))
        got = {}
        for dev in ("cuda", "cpu"):
            p = {k: v.to(dev) for k, v in params.items()}
            z = [torch.from_numpy(a).to(dev) for a in inputs]
            weights, got[dev] = {}, []
            for _ in range(2):
                with _Int8Calls() as calls, torch.inference_mode(), \
                        quant.quantized(scales, weights):
                    if family == "ssgan":
                        y = model.sample(p, *z,
                                         draws={"epsilon": eps.to(dev)})
                    elif family == "gmgan":
                        y = model.sample(p, *z)
                    else:
                        y = model.sample(p, z[0])
                got[dev].append((y.float().cpu(), calls))
        for call, ((y_card, calls_card), (y_cpu, calls_cpu)) in enumerate(
                zip(got["cuda"], got["cpu"])):
            flips, first = 0, []
            for i, ((xa, sa, aa), (xb, sb, ab)) in enumerate(
                    zip(calls_card.q1, calls_cpu.q1)):
                qa = kq.quantize_int8_plain(xa.cpu(), sa, aa)
                qb = kq.quantize_int8_plain(xb, sb, ab)
                flips += int((qa != qb).sum())
                d = float((xa.cpu().float() - xb.float()).abs().max())
                if d > 0 and len(first) < 3:  # where the two runs part
                    first.append({"q1_call": i, "shape": list(xb.shape),
                                  "input_max_abs_diff": d,
                                  "flips": int((qa != qb).sum())})
            k2b_flips = sum(int((ka[-1].cpu() != kb[-1]).sum()) for ka, kb
                            in zip(calls_card.k2b, calls_cpu.k2b))
            diff = (y_card - y_cpu).abs()
            rec = {"check": "int8 sampler card vs cpu", "family": family,
                   "call": call, "B": INT8_E2E_B, "dtype": "float32",
                   "int8_values": sum(c[0].numel() for c in calls_cpu.q1)
                   + sum(k[-1].numel() for k in calls_cpu.k2b),
                   "flips": flips + k2b_flips, "k2b_copy_flips": k2b_flips,
                   "max_abs_diff": float(diff.max()),
                   "beyond_atol": int((diff > INT8_E2E_ATOL).sum()),
                   "elements": diff.numel(), "bound": INT8_E2E_ATOL,
                   "q1_calls": len(calls_cpu.q1),
                   "k2b_q8_calls": [len(calls_card.k2b),
                                    len(calls_cpu.k2b)],
                   "first_differing_inputs": first}
            log(rec)
            if flips or k2b_flips or len(calls_card.k2b) != len(
                    calls_cpu.k2b) or not float(diff.max()) <= INT8_E2E_ATOL:
                misses.append(f"int8 {family}: card vs cpu {rec}")
            out.append(rec)
    return out


def _int8_dispatch(card):
    """Device ms of one cifar10 sampler dispatch at B 8 and 256: the int8
    sampler against the float one, f32 and bf16 activations alike."""
    import torch
    from graphical_gan_tpu_torch.serve.export import make_sampler
    from graphical_gan_tpu_torch.serve.quantize import (
        calibrate, quantized_entry)
    rows = []
    for dtype in ("float32", "bfloat16"):
        model = _published(dtype)
        params = model.init(0, "cuda")
        flt = make_sampler("gan_inference", model)[0]
        q = quantized_entry(flt, calibrate("gan_inference", model, params,
                                           11, n_batches=1,
                                           batch_size=INT8_CALIB_B))
        for b in INT8_DISPATCH_BUCKETS:
            # codes in the compute dtype: G runs in its codes' dtype
            z = torch.randn((b, model.cfg.dim_latent), device="cuda",
                            dtype=getattr(torch, dtype))
            with torch.inference_mode():
                row = {"phase": "int8-export", "dispatch": "cifar10 sampler",
                       "dtype": dtype, "B": b,
                       "int8_device_ms": time_ms(
                           lambda t: q(params, 0, t), [z], 5, 10),
                       "float_device_ms": time_ms(
                           lambda t: flt(params, 0, t), [z], 5, 10),
                       "card": card}
            log(row)
            rows.append(row)
    return rows


# launches of the int8 cifar10 sampler's kernels per dispatch after its
# first call: Q1 at the latents only, Q2 at its four layers, K2a and K2b
# with its int8 copy at its three BNs (each BN's copy feeds its deconv)
INT8_PER_DISPATCH = {"quantize_int8": 1, "int8_conv": 4, "bn_stats": 3,
                     "bn_apply_q8": 3, "bn_apply": 0}


def _int8_serve(base, launch_totals, int8_out):
    """The main path: a cifar10 wali-gp run directory (published width,
    random weights) served with ``--quantize int8`` over HTTP, a seeded
    request per bucket 8 and 256 and an exact one; the launches counted
    from zero over that run (Q2's also per route), held to
    INT8_PER_DISPATCH."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.ops import kernels
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import serve_run_dir
    from graphical_gan_tpu_torch.tools.bench_server import write_run_dir
    run_dir = write_run_dir(os.path.join(base, "run"), "gan_inference",
                            "float32")
    httpd, batcher, identity, _ = serve_run_dir(
        run_dir, "sampler", "cuda", buckets=BUCKETS, port=0,
        quantize="int8", warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = SamplerClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        client.sample(n=1, seed=0)  # calibration done; weights quantized
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs = [client.sample(n=n, seed=s) for s, n in ((1, 8), (2, 256))]
        outs.append(client.sample(n=8, seed=3, exact=True))
        torch.cuda.synchronize()
        got = kernels.launches()
        routes = dict(kq.int8_conv.routes)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    launch_totals.update(got)
    int8_out["serve_routes"] = routes
    ok = all(o.shape[1] == 3072 and np.isfinite(o).all()
             and float(np.abs(o).max()) <= 1.0 for o in outs)
    want = {k: v * len(outs) for k, v in INT8_PER_DISPATCH.items()}
    log({"phase": "int8-export", "serve": "cifar10 wali-gp --quantize int8",
         "identity_quantization": identity["quantization"],
         "rows": [o.shape[0] for o in outs], "finite_in_range": ok,
         "launches": got, "expected_launches": want,
         "int8_conv_routes": routes})
    if identity["quantization"] != "int8" or not ok:
        fail(f"int8 serving: identity {identity}, outputs ok {ok}")
    if any(got[k] != v for k, v in want.items()) or routes["mma"]:
        fail(f"int8 serving launches {got} (Q2 routes {routes}), want "
             f"{want}, every Q2 call on the tma route")


# (entry, quantize) of the cifar10 run directory the export check exports:
# the int8 sampler runs Q1, Q2, K2a and K2b, the float reconstructor K1,
# K2a, K2b and G's deconvs on cuDNN
EXPORT_CASES = (("sampler", "int8"), ("reconstructor", None))
EXPORT_ROWS = (8, 256)
_EXPORT_SERVE_CODE = """
import json, sys, threading
sys.path.insert(0, {root!r})
import numpy as np
from graphical_gan_tpu_torch.ops import kernels
from graphical_gan_tpu_torch.serve.client import SamplerClient
from graphical_gan_tpu_torch.serve.server import serve_run_dir
out = {{}}
for name, export_dir, data in {cases!r}:
    httpd, batcher, identity, _ = serve_run_dir(
        export_dir=export_dir, buckets={rows!r}, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = SamplerClient(
            "http://127.0.0.1:%d" % httpd.server_address[1])
        ref = np.load(data)
        kernels.reset_launches()
        rec = {{"identity": identity, "equal": {{}}, "max_abs_diff": {{}}}}
        for n in {rows!r}:
            inputs = [ref["%d_in%d" % (n, i)] for i in range(len(
                batcher.input_shapes))]
            got = client.sample(inputs=inputs, seed={seed}, exact=True)
            want = ref["%d_out" % n]
            rec["equal"][n] = bool(np.array_equal(got, want))
            rec["max_abs_diff"][n] = float(np.abs(got - want).max())
            if identity["entry"] == "sampler":  # a batched request too
                b = client.sample(n=n, seed=n)
                rec.setdefault("batched_finite", []).append(
                    bool(b.shape[0] == n and np.isfinite(b).all()))
        rec["launches"] = kernels.launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    out[name] = rec
print(json.dumps(out))
"""
# the kernels each exported program must have launched in the fresh process
EXPORT_KERNELS = {"sampler-int8": ("quantize_int8", "int8_conv", "bn_stats",
                                   "bn_apply_q8"),
                  "reconstructor-None": ("fused_conv2d_bias_act", "bn_stats",
                                         "bn_apply")}


def _int8_export(base, misses):
    """The cifar10 wali-gp run directory (published width) exported on
    the card: the sampler int8 (calibrated as the server calibrates, seed
    11) and the reconstructor float; each loaded in a fresh process and
    served there through ``--export-dir``'s path over HTTP, its exact
    requests of 8 and 256 rows held to the run-directory entry's outputs
    bit for bit, its launches counted there."""
    import numpy as np
    from graphical_gan_tpu_torch.serve.export import export_sampler
    from graphical_gan_tpu_torch.serve.server import sampler_from_run_dir
    run_dir = os.path.join(base, "run")
    cases = []
    for entry, quantize in EXPORT_CASES:
        name = f"{entry}-{quantize}"
        t0 = time.perf_counter()
        info = export_sampler(run_dir, entry=entry, quantize=quantize,
                              calib_seed=11, out=os.path.join(base, name),
                              device="cuda")
        export_s = time.perf_counter() - t0
        call, kinds, shapes, _ = sampler_from_run_dir(
            run_dir, entry=entry, device="cuda", quantize=quantize)
        rng = np.random.default_rng(3)
        arrays = {}
        for n in EXPORT_ROWS:
            inputs = [(rng.random((n,) + tuple(s[1:])) * 255).astype(
                np.float32) if k == "image" else rng.standard_normal(
                (n,) + tuple(s[1:]), dtype=np.float32)
                for k, s in zip(kinds, shapes)]
            arrays.update({f"{n}_in{i}": a for i, a in enumerate(inputs)})
            arrays[f"{n}_out"] = call(7, *inputs)
        data = os.path.join(base, f"{name}.npz")
        np.savez(data, **arrays)
        cases.append((name, os.path.dirname(info["blob"]), data))
        log({"phase": "int8-export", "export": name,
             "symbolic_batch": info["symbolic_batch"],
             "draws": [d["name"] for d in info["draws"]],
             "pt2_bytes": os.path.getsize(info["blob"]),
             "export_seconds": export_s})
    code = _EXPORT_SERVE_CODE.format(root=ROOT, cases=cases,
                                     rows=EXPORT_ROWS, seed=7)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"export served in a fresh process: {res.stderr[-3000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for name, rec in got.items():
        log({"check": "export served through --export-dir", "case": name,
             **rec})
        if not all(rec["equal"].values()):
            misses.append(f"export {name}: outputs differ from the run "
                          f"directory's {rec['max_abs_diff']}")
        if not all(rec.get("batched_finite", [True])):
            misses.append(f"export {name}: a batched request failed")
        missing = [k for k in EXPORT_KERNELS[name]
                   if not rec["launches"].get(k)]
        if missing:
            misses.append(f"export {name}: {missing} never launched inside "
                          "the program")


def phase_int8(launch_totals, card, int8_out):
    """The int8 serving path on the card: Q1, Q2 and K2b's int8 copy
    against their plain versions at every layer of the published samplers
    (buckets 8, 64, 256; f32 and bf16), timed (Q2's two routes side by
    side at cifar10's shapes); the quantized samplers against the CPU's;
    the cifar10 dispatch int8 against float; the server with --quantize
    int8 over HTTP, its launches counted from zero; then the run directory
    exported (torch.export) float and int8 and served from the artifacts
    in a fresh process, bit for bit against the run directory."""
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_int8")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    misses, timings = [], []
    t0 = time.perf_counter()
    err, checked = _int8_sampler_checks(card, timings, misses)
    log({"check": "Q1/Q2/K2b+Q1 at the samplers' layers", **checked, **err,
         "misses": misses[:20],
         "seconds": round(time.perf_counter() - t0, 3)})
    for part, fn, args in (("e2e", _int8_e2e, (misses,)),
                           ("dispatch", _int8_dispatch, (card,)),
                           ("serve", _int8_serve,
                            (base, launch_totals, int8_out)),
                           ("export", _int8_export, (base, misses))):
        t0 = time.perf_counter()
        fn(*args)
        log({"int8_seconds": part,
             "seconds": round(time.perf_counter() - t0, 3)})
    for r in timings:
        log({"phase": "int8-export", **r})
    int8_out.update(err=err, timings=timings)
    if misses:
        fail(f"int8-export: {misses[:20]}")


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
# the int8 sampler: Q1, Q2, and G's batch-stat BN in float (K2a, K2b with
# its int8 copy)
INT8_KERNELS = ("quantize_int8", "int8_conv", "bn_stats", "bn_apply_q8")


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
                and r["dtype"] == dn and r["B"] == b and "family" not in r]
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


def summary(errs, timings, launches, int8_out):
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
    ``launches_loaders`` / ``_eval`` / ``_learn`` / ``_step_options`` /
    ``_family2`` / ``_cluster`` / ``_family2_learn`` / ``_family3`` /
    ``_family3_serve`` / ``_family3_learn`` / ``_tools`` / ``_fault4`` /
    ``_phase_deconv`` / ``_int8`` / ``_frozen`` (score_samples' generator)
    / ``_quality_run`` / ``_library`` those phases' runs (K1's
    ``_phase_deconv``: the phase route at the eight bench shapes); K1 adds
    ``family3_rows``, its times at family 3's shapes (B 50 videos). Q1
    and Q2 follow (:func:`_int8_summary`)."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        k3 = name in K3_KERNELS
        backward = name not in SERVE_KERNELS and not k3
        b = 64 if backward else 256
        rows = [r for r in timings if r["kernel"] == name
                and "family" not in r and (
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
                       for path in ("loaders", "eval", "learn",
                                    "step_options", "family2", "cluster",
                                    "family2_learn", "family3",
                                    "family3_serve", "family3_learn",
                                    "tools", "fault4", "phase_deconv",
                                    "int8", "frozen", "quality_run",
                                    "library")},
                    "max_abs_err": errs[name],
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"),
                    "bound_by": ("operations" if ops_ms >= bytes_ms
                                 else "bytes"),
                    "library_ms": total("library_ms"),
                    "summed_over": over})
        if name == "fused_conv2d_bias_act":
            out[-1]["rows"] = _k1_rows(timings, launches["k1"])
            out[-1]["family3_rows"] = [
                {k: r[k] for k in ("shape", "B", "dtype", "path", "tile",
                                   "splits", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")}
                for r in timings if r.get("family") == 3]
        if k3:
            out[-1]["rows"] = _k3_rows(timings, name)
        if name == "bn_stats":
            out[-1]["rows"] = _bn_rows(timings, name)
        if name == "bn_bwd":  # max_abs_err is dx's; red sums R terms
            out[-1]["red_max_abs_err"] = errs["bn_bwd_red"]
            out[-1]["rows"] = _bn_rows(timings, name)
    out += _split_summary(errs, timings, launches["parallel"])
    out += _int8_summary(launches["int8"], int8_out)
    return {"kernels": out}


def _split_summary(errs, timings, launches):
    """K2a's (with K2b) and K2c+K2d's split modes: times summed over one
    training iteration's 5 BN shapes at one rank's rows of B=64 over
    SPLIT_RANKS ranks, f32; launches from the parallel phase's 2-rank runs
    (rank 0; the int8 form's from the dp server's int8 dispatches); the
    library's second readings (``library_var_mean_ms``, the finalize's
    ``library_finalize_ms``), the split forward and backward chains
    (``chain_ms``, ``bwd_chain_ms``) and the one-launch K2b at the apply's
    rows (``k2b_ms``) summed alike where
    a kernel has them; ``rows`` every timed shape and
    world size with the one-launch kernels' times over the whole batch
    beside it."""
    out = []
    for name, (src, replaces) in SPLIT_SOURCES.items():
        rows = [r for r in timings if r["kernel"] == name]
        main = [r for r in rows if r["dtype"] == "float32"
                and r["ranks"] == SPLIT_RANKS]
        ops_ms = sum(r["bound_ms"] for r in main
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in main
                       if r["bound_by"] == "bytes")

        def total(key):
            got = [r.get(key) for r in main]
            return None if None in got else sum(got)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total("library_ms"),
            **{key: total(key) for key in ("library_var_mean_ms",
                                           "library_finalize_ms",
                                           "chain_ms", "bwd_chain_ms",
                                           "k2b_ms")
               if any(key in r for r in main)},
            "summed_over": f"one training iteration's 5 BN shapes, one "
                           f"rank's rows of B={SPLIT_B} over {SPLIT_RANKS} "
                           "ranks, f32",
            "rows": [{k: r[k] for k in r if k not in ("kernel", "card")}
                     for r in rows]})
    return out


INT8_SOURCES = {
    "quantize_int8": ("graphical_gan_tpu_torch/csrc/quant.cu",
                      "graphical_gan_tpu/ops/quant.py:103"),
    # the three int8 contractions of the intercepts (XLA, no Pallas
    # kernel); the tma route's kernel is quant_tma.cu
    "int8_conv": ("graphical_gan_tpu_torch/csrc/quant_tma.cu",
                  "graphical_gan_tpu/ops/quant.py:131, "
                  "graphical_gan_tpu/ops/quant.py:149, "
                  "graphical_gan_tpu/ops/quant.py:167"),
    # K2b (the BN apply's pallas_call) with Q1 of its output folded in
    "bn_apply_q8": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                    "graphical_gan_tpu/ops/pallas/fused_norm.py:182, "
                    "graphical_gan_tpu/ops/quant.py:103"),
}


def _int8_summary(launches, int8_out):
    """Q1, Q2 and K2b with its int8 copy: times summed over one int8
    cifar10 sampler dispatch at B=256 in f32 after its first call (Q1 at
    the latents: the BNs' outputs come as K2b's int8 copies, the weights
    are quantized once), launches from the int8 serving run; ``rows``
    every timed shape. Q2 adds ``mma_route_ms``, its ``mma`` route at the
    same shapes in the same run, and ``routes``, the serving run's
    launches per ``q2_plan`` route; K2b's copy adds ``k2b_ms`` (K2b alone)
    and ``q1_ms`` (the Q1 pass it saves). No PyTorch call computes Q1
    (torch's quantize_per_tensor multiplies by the scale's inverse and
    clamps to -128), a conv of Q2 or K2b's pair of outputs, so their
    library_ms is null; Q2's dense rows carry torch._int_mm's time where
    it takes the shape."""
    out = []
    err = int8_out["err"]
    for name, (src, replaces) in INT8_SOURCES.items():
        rows = [r for r in int8_out["timings"] if r["kernel"] == name]
        main = [r for r in rows if r["family"] == "gan_inference"
                and r["B"] == 256 and r["dtype"] == "float32"]
        ops_ms = sum(r["bound_ms"] for r in main
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in main
                       if r["bound_by"] == "bytes")
        rec = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": {"quantize_int8": err["q1"],
                            "int8_conv": err["q2_out"],
                            "bn_apply_q8": err["k2b_q8"]}[name],
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "summed_over": "one int8 cifar10 sampler dispatch, B=256, f32",
            "rows": [{k: r[k] for k in r if k not in ("kernel", "card")}
                     for r in rows]}
        if name == "int8_conv":
            rec["sums_max_abs_err"] = err["q2_sums"]
            rec["mma_route_ms"] = sum(r["mma_ms"] or 0.0 for r in main)
            rec["routes"] = int8_out.get("serve_routes")
        if name == "bn_apply_q8":
            rec["k2b_ms"] = sum(r["k2b_ms"] for r in main)
            rec["q1_ms"] = sum(r["q1_ms"] for r in main)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# frozen Inception-2015: a GraphDef writer and the v3 architecture. The
# card's machine has neither TensorFlow nor protobuf, so the graph the
# frozen-inception phase reads is written here, message by message, with
# the op sequence and channel plan of the 2015 classify_image graph
# (tests/test_inception_full_graph.py: _V3Builder, whose random draws it
# repeats in the same order) and random weights from a numpy seed.

# TF DataType enum values (tensorflow/core/framework/types.proto)
TF_FLOAT, TF_INT32 = 1, 3
# the attributes whose int value is a DataType
_PB_TYPE_ATTRS = ("T", "DstT", "SrcT", "Tshape", "Tidx", "Tdim", "Tpaddings",
                  "out_type", "dtype")


def _pb_varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s as their two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_int(field: int, n: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(int(n))


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def pb_tensor(arr) -> bytes:
    """TensorProto: dtype (1), tensor_shape (2: a dim (2) per axis, each
    its size (1)), tensor_content (4)."""
    import numpy as np
    dtype = {np.dtype(np.float32): TF_FLOAT,
             np.dtype(np.int32): TF_INT32}[arr.dtype]
    shape = b"".join(_pb_bytes(2, _pb_int(1, d)) for d in arr.shape)
    return (_pb_int(1, dtype) + _pb_bytes(2, shape)
            + _pb_bytes(4, np.ascontiguousarray(arr).tobytes()))


def pb_attr(key: str, value) -> bytes:
    """AttrValue by the value's Python type: bytes s (2), bool b (5), int
    i (3) or type (6) for the DataType attributes, float f (4), a list of
    ints list.i (1: 3, packed), an ndarray tensor (8)."""
    import struct
    import numpy as np
    if isinstance(value, bytes):
        body = _pb_bytes(2, value)
    elif isinstance(value, bool):
        body = _pb_int(5, value)
    elif isinstance(value, int):
        body = _pb_int(6 if key in _PB_TYPE_ATTRS else 3, value)
    elif isinstance(value, float):
        body = _pb_varint(4 << 3 | 5) + struct.pack("<f", value)
    elif isinstance(value, list):
        body = _pb_bytes(1, _pb_bytes(3, b"".join(_pb_varint(v)
                                                  for v in value)))
    elif isinstance(value, np.ndarray):
        body = _pb_bytes(8, pb_tensor(value))
    else:
        raise TypeError(f"attr {key}: {type(value).__name__}")
    return body


def pb_node(name: str, op: str, inputs, attrs) -> bytes:
    """NodeDef: name (1), op (2), input (3 each), attr (5: map entries of
    key (1) and AttrValue (2))."""
    out = _pb_bytes(1, name.encode()) + _pb_bytes(2, op.encode())
    for i in inputs:
        out += _pb_bytes(3, i.encode())
    for k, v in attrs.items():
        out += _pb_bytes(5, _pb_bytes(1, k.encode())
                         + _pb_bytes(2, pb_attr(k, v)))
    return out


def pb_graphdef(nodes, producer: int = 8) -> bytes:
    """GraphDef: node (1 each), versions (4: producer (1)); producer 8 is
    older than BatchNormWithGlobalNormalization's deprecation."""
    return (b"".join(_pb_bytes(1, pb_node(*n)) for n in nodes)
            + _pb_bytes(4, _pb_int(1, producer)))


def graph_const(name, arr, dtype=None):
    """A Const node as tests/test_inception_frozen.py: _const makes it."""
    import numpy as np
    arr = np.asarray(arr, dtype or np.float32)
    return (name, "Const", [], {
        "dtype": TF_INT32 if arr.dtype == np.int32 else TF_FLOAT,
        "value": arr})


def graph_node(name, op, inputs, **attrs):
    """A node with tests/test_inception_frozen.py: _node's defaults."""
    if "T" not in attrs and op not in ("Placeholder", "Const"):
        attrs["T"] = TF_FLOAT
    if op in ("ConcatV2", "Concat"):
        attrs.setdefault("Tidx", TF_INT32)
    if op == "Reshape":
        attrs.setdefault("Tshape", TF_INT32)
    if op == "ExpandDims":
        attrs.setdefault("Tdim", TF_INT32)
    return (name, op, list(inputs), attrs)


def graph_feed(name="ExpandDims"):
    return (name, "Placeholder", [], {"dtype": TF_FLOAT})


class V3Graph:
    """The 2015 graph's op pattern, as tests/test_inception_full_graph.py:
    _V3Builder emits it: each conv is Conv2D -> BatchNormWithGlobal
    Normalization (scale_after_normalization False) -> Relu, branches
    join in a Concat whose axis is input 0."""

    def __init__(self, seed: int):
        import numpy as np
        self.rng = np.random.RandomState(seed)
        self.nodes = []
        self.channels = {}

    def conv(self, name, src, cin, cout, kh, kw, stride=1, padding=b"SAME"):
        import numpy as np
        r = self.rng
        self.nodes += [
            graph_const(f"{name}/w",
                        (r.randn(kh, kw, cin, cout)
                         * (0.35 / np.sqrt(kh * kw * cin))).astype(
                             np.float32)),
            graph_node(f"{name}/conv", "Conv2D", [src, f"{name}/w"],
                       strides=[1, stride, stride, 1], padding=padding),
            graph_const(f"{name}/bn/m",
                        r.randn(cout).astype(np.float32) * 0.1),
            graph_const(f"{name}/bn/v",
                        r.rand(cout).astype(np.float32) * 0.5 + 0.75),
            graph_const(f"{name}/bn/beta",
                        r.randn(cout).astype(np.float32) * 0.1),
            graph_const(f"{name}/bn/gamma", np.ones(cout, np.float32)),
            graph_node(f"{name}/bn", "BatchNormWithGlobalNormalization",
                       [f"{name}/conv", f"{name}/bn/m", f"{name}/bn/v",
                        f"{name}/bn/beta", f"{name}/bn/gamma"],
                       variance_epsilon=0.001,
                       scale_after_normalization=False, T=TF_FLOAT),
            graph_node(name, "Relu", [f"{name}/bn"]),
        ]
        self.channels[name] = cout
        return name

    def maxpool(self, name, src, stride=2, padding=b"VALID"):
        self.nodes.append(graph_node(name, "MaxPool", [src],
                                     ksize=[1, 3, 3, 1],
                                     strides=[1, stride, stride, 1],
                                     padding=padding))
        self.channels[name] = self.channels[src]
        return name

    def avgpool(self, name, src):
        self.nodes.append(graph_node(name, "AvgPool", [src],
                                     ksize=[1, 3, 3, 1],
                                     strides=[1, 1, 1, 1], padding=b"SAME"))
        self.channels[name] = self.channels[src]
        return name

    def concat(self, name, srcs):
        import numpy as np
        self.nodes += [
            graph_const(f"{name}/axis", np.asarray(3, np.int32), np.int32),
            graph_node(name, "Concat", [f"{name}/axis"] + list(srcs),
                       N=len(srcs)),
        ]
        self.channels[name] = sum(self.channels[s] for s in srcs)
        return name

    def mixed_35(self, name, src, pool_proj):
        cin = self.channels[src]
        b0 = self.conv(f"{name}/b0", src, cin, 64, 1, 1)
        b1 = self.conv(f"{name}/b1a", src, cin, 48, 1, 1)
        b1 = self.conv(f"{name}/b1b", b1, 48, 64, 5, 5)
        b2 = self.conv(f"{name}/b2a", src, cin, 64, 1, 1)
        b2 = self.conv(f"{name}/b2b", b2, 64, 96, 3, 3)
        b2 = self.conv(f"{name}/b2c", b2, 96, 96, 3, 3)
        b3 = self.avgpool(f"{name}/b3pool", src)
        b3 = self.conv(f"{name}/b3", b3, cin, pool_proj, 1, 1)
        return self.concat(name, [b0, b1, b2, b3])

    def mixed_17(self, name, src, c7):
        cin = self.channels[src]
        b0 = self.conv(f"{name}/b0", src, cin, 192, 1, 1)
        b1 = self.conv(f"{name}/b1a", src, cin, c7, 1, 1)
        b1 = self.conv(f"{name}/b1b", b1, c7, c7, 1, 7)
        b1 = self.conv(f"{name}/b1c", b1, c7, 192, 7, 1)
        b2 = self.conv(f"{name}/b2a", src, cin, c7, 1, 1)
        b2 = self.conv(f"{name}/b2b", b2, c7, c7, 7, 1)
        b2 = self.conv(f"{name}/b2c", b2, c7, c7, 1, 7)
        b2 = self.conv(f"{name}/b2d", b2, c7, c7, 7, 1)
        b2 = self.conv(f"{name}/b2e", b2, c7, 192, 1, 7)
        b3 = self.avgpool(f"{name}/b3pool", src)
        b3 = self.conv(f"{name}/b3", b3, cin, 192, 1, 1)
        return self.concat(name, [b0, b1, b2, b3])

    def mixed_8x8(self, name, src):
        cin = self.channels[src]
        b0 = self.conv(f"{name}/b0", src, cin, 320, 1, 1)
        b1 = self.conv(f"{name}/b1a", src, cin, 384, 1, 1)
        b1l = self.conv(f"{name}/b1b", b1, 384, 384, 1, 3)
        b1r = self.conv(f"{name}/b1c", b1, 384, 384, 3, 1)
        b1 = self.concat(f"{name}/b1cat", [b1l, b1r])
        b2 = self.conv(f"{name}/b2a", src, cin, 448, 1, 1)
        b2 = self.conv(f"{name}/b2b", b2, 448, 384, 3, 3)
        b2l = self.conv(f"{name}/b2c", b2, 384, 384, 1, 3)
        b2r = self.conv(f"{name}/b2d", b2, 384, 384, 3, 1)
        b2 = self.concat(f"{name}/b2cat", [b2l, b2r])
        b3 = self.avgpool(f"{name}/b3pool", src)
        b3 = self.conv(f"{name}/b3", b3, cin, 192, 1, 1)
        return self.concat(name, [b0, b1, b2, b3])


def inception_v3_2015_nodes(seed: int = 0, n_classes: int = 1008,
                            stages: int = 4):
    """The nodes of tests/test_inception_full_graph.py:
    build_inception_v3_2015(seed, n_classes): the input pipeline (Cast,
    legacy ResizeBilinear to 299, Sub 128, Mul 1/128), the stem, 3 mixed
    35x35 modules, mixed_3, 4 mixed 17x17, mixed_8, 2 mixed 8x8, pool_3
    and the bias-free 2048 x n_classes head. ``stages`` < 4 stops after the
    stem (1), the 35x35 modules (2) or the 17x17 ones (3), pool_3 then
    averaging the whole map (the tests' reduced graphs)."""
    import numpy as np
    b = V3Graph(seed)
    b.nodes += [
        graph_feed(),
        graph_node("Cast", "Cast", ["ExpandDims"], SrcT=TF_FLOAT,
                   DstT=TF_FLOAT),
        graph_const("resize/size", np.asarray([299, 299], np.int32),
                    np.int32),
        graph_node("ResizeBilinear", "ResizeBilinear",
                   ["Cast", "resize/size"]),
        graph_const("Sub/y", 128.0),
        graph_node("Sub", "Sub", ["ResizeBilinear", "Sub/y"]),
        graph_const("Mul/y", 1.0 / 128.0),
        graph_node("Mul", "Mul", ["Sub", "Mul/y"]),
    ]
    b.channels["Mul"] = 3
    h = b.conv("conv", "Mul", 3, 32, 3, 3, stride=2, padding=b"VALID")
    h = b.conv("conv_1", h, 32, 32, 3, 3, padding=b"VALID")
    h = b.conv("conv_2", h, 32, 64, 3, 3)
    h = b.maxpool("pool", h)
    h = b.conv("conv_3", h, 64, 80, 1, 1, padding=b"VALID")
    h = b.conv("conv_4", h, 80, 192, 3, 3, padding=b"VALID")
    h = b.maxpool("pool_1", h)
    grid = 35
    if stages >= 2:
        h = b.mixed_35("mixed", h, pool_proj=32)
        h = b.mixed_35("mixed_1", h, pool_proj=64)
        h = b.mixed_35("mixed_2", h, pool_proj=64)
    if stages >= 3:
        cin = b.channels[h]
        r0 = b.conv("mixed_3/b0", h, cin, 384, 3, 3, stride=2,
                    padding=b"VALID")
        r1 = b.conv("mixed_3/b1a", h, cin, 64, 1, 1)
        r1 = b.conv("mixed_3/b1b", r1, 64, 96, 3, 3)
        r1 = b.conv("mixed_3/b1c", r1, 96, 96, 3, 3, stride=2,
                    padding=b"VALID")
        r2 = b.maxpool("mixed_3/b2pool", h)
        h = b.concat("mixed_3", [r0, r1, r2])
        h = b.mixed_17("mixed_4", h, c7=128)
        h = b.mixed_17("mixed_5", h, c7=160)
        h = b.mixed_17("mixed_6", h, c7=160)
        h = b.mixed_17("mixed_7", h, c7=192)
        grid = 17
    if stages >= 4:
        cin = b.channels[h]
        r0 = b.conv("mixed_8/b0a", h, cin, 192, 1, 1)
        r0 = b.conv("mixed_8/b0b", r0, 192, 320, 3, 3, stride=2,
                    padding=b"VALID")
        r1 = b.conv("mixed_8/b1a", h, cin, 192, 1, 1)
        r1 = b.conv("mixed_8/b1b", r1, 192, 192, 1, 7)
        r1 = b.conv("mixed_8/b1c", r1, 192, 192, 7, 1)
        r1 = b.conv("mixed_8/b1d", r1, 192, 192, 3, 3, stride=2,
                    padding=b"VALID")
        r2 = b.maxpool("mixed_8/b2pool", h)
        h = b.concat("mixed_8", [r0, r1, r2])
        h = b.mixed_8x8("mixed_9", h)
        h = b.mixed_8x8("mixed_10", h)
        grid = 8
    c = b.channels[h]
    rng = b.rng
    b.nodes += [
        graph_node("pool_3", "AvgPool", [h], ksize=[1, grid, grid, 1],
                   strides=[1, 1, 1, 1], padding=b"VALID"),
        graph_const("softmax/w",
                    (rng.randn(c, n_classes) * 0.05).astype(np.float32)),
        graph_const("pool_3/shape", np.asarray([-1, c], np.int32), np.int32),
        graph_node("pool_3/reshaped", "Reshape", ["pool_3", "pool_3/shape"],
                   T=TF_FLOAT),
        graph_node("softmax/logits/MatMul", "MatMul",
                   ["pool_3/reshaped", "softmax/w"]),
        graph_node("softmax", "Softmax", ["softmax/logits/MatMul"]),
    ]
    return b.nodes


def inception_v3_2015_graphdef(seed: int = 0, n_classes: int = 1008,
                               stages: int = 4) -> bytes:
    """``inception_v3_2015_nodes`` serialized (about 95 MB in full)."""
    return pb_graphdef(inception_v3_2015_nodes(seed, n_classes, stages))


# ---------------------------------------------------------------------------
# this slice's phases: the frozen Inception-2015 scorer on the card, the
# bf16-vs-f32 quality tool, and the library ops no model uses

FROZEN_BATCH = 100      # the reference's IS batch (inception_score.py:34)
FROZEN_HW = 32          # cifar10's images, resized to 299 in the graph
FROZEN_TIME_CALLS = 5
FROZEN_PARITY_N = 8
# the card (cuDNN, no TF32) against the CPU on the same graph and images:
# ~100 chained f32 conv + BN layers summed in other orders
FROZEN_POOL_REL_L2 = 1e-4
FROZEN_PROB_REL_L2 = 1e-4
FROZEN_SCORE_ARGS = ["--dataset", "cifar10", "--mode", "wali-gp",
                     "--n-samples", "200", "--splits", "2"]
# tools/quality_run.py at the published width, cut in depth
QUALITY_ITERS = 100
QUALITY_SAMPLES = 1000
QUALITY_KEYS = {"dtype", "iters", "params_finite", "losses_finite", "final",
                "disc_cost_windows", "train_throughput_img_per_sec",
                "wall_seconds", "fid_vs_train", "hermetic_is"}
# a part-B op on the card against its CPU run: each output elementwise
# (f32 sums in other orders, K1's in the convs; atol of the array's largest
# magnitude), each gradient by its relative L2 error within GRAD_RTOL, as
# train-parity holds gradients: cuDNN's f32 weight gradient of a 5x5
# stride-1 conv is Winograd's (winogradWgrad*9x9_5x5, deterministic or
# not), 5.8e-4 of the norm off the f64 result and 2.1e-3 of the largest
# element, where the CPU's and cuDNN-off's are 1.5e-7 (H100 80GB HBM3,
# 700 W); a wrong gradient formula is off by O(1)
LIB_RTOL = 1e-4
LIB_ATOL_REL = 1e-5


def _frozen_dir():
    return os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_frozen")


def _valid_taps(n: int, k: int, s: int, padding: str) -> int:
    """Taps of a k-wide window at stride s over n inputs that land inside
    the input, summed over one axis's outputs (TF's SAME or VALID)."""
    if padding == "VALID":
        return ((n - k) // s + 1) * k
    from graphical_gan_tpu_torch.ops.kernels.fused_conv import same_pads
    return conv_valid_taps(n, k, s, same_pads(n, k, s)[0])


def frozen_flops(nodes, batch: int, hw: int = FROZEN_HW) -> dict:
    """The operations one forward of the frozen graph needs at ``batch``
    images of hw x hw: each Conv2D's products and sums, the taps in its
    padding left out, and the bias-free head's product, from the tensor
    shapes of a run on the meta device (no compute)."""
    import torch
    from graphical_gan_tpu_torch.metrics.inception_frozen import (
        FrozenInceptionClassifier as Frozen, GraphInterpreter)
    interp = GraphInterpreter(nodes, "meta")
    counts = {"conv": 0.0, "n_conv": 0}
    evaluate = interp._eval_node

    def counted(node, ref):
        if node.op == "Conv2D":
            x, w = ref(node.inputs[0]), ref(node.inputs[1])  # NHWC, HWIO
            kh, kw, cin, cout = w.shape
            _, sh, sw, _ = node.attr("strides")
            pad = node.attr("padding").decode()
            counts["conv"] += 2.0 * x.shape[0] * cin * cout \
                * _valid_taps(x.shape[1], kh, sh, pad) \
                * _valid_taps(x.shape[2], kw, sw, pad)
            counts["n_conv"] += 1
        return evaluate(node, ref)

    interp._eval_node = counted
    w_ref = interp.nodes[Frozen.LOGITS_MATMUL].inputs[1]
    pool, w = interp.make_fn(Frozen.FEED, [Frozen.POOL, w_ref])(
        torch.zeros((batch, hw, hw, 3), device="meta"))
    head = 2.0 * batch * w.shape[0] * w.shape[1]
    return {"flops": counts["conv"] + head, "conv_flops": counts["conv"],
            "head_flops": head, "n_conv": counts["n_conv"],
            "pool_3": list(pool.shape)}


class _FrozenCalls:
    """Counts ``FrozenInceptionClassifier.pool3_and_probs`` calls by the
    device of their input, wherever the classifier was built."""

    def __init__(self):
        from graphical_gan_tpu_torch.metrics.inception_frozen import (
            FrozenInceptionClassifier)
        self.cls = FrozenInceptionClassifier
        self.orig = FrozenInceptionClassifier.pool3_and_probs
        self.calls = {}

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def counted(clf, x):
            calls[x.device.type] = calls.get(x.device.type, 0) + 1
            return orig(clf, x)
        self.cls.pool3_and_probs = counted
        return self

    def __exit__(self, *exc):
        self.cls.pool3_and_probs = self.orig


def phase_frozen_inception(launch_totals, frozen_out):
    """The frozen Inception-2015 scorer on the card: the complete v3
    architecture written as a GraphDef (``inception_v3_2015_graphdef``,
    random weights from seed 0), read by the port's reader into
    ``FrozenInceptionClassifier(device="cuda")``; images/s at batch
    FROZEN_BATCH of 32x32x3 images in [0, 255] from CUDA events against the
    f32 bound of its operations (readings beside it: the time with cuDNN
    free to pick non-deterministic algorithms, and ``_profile``'s device
    ms by kernel group); then ``default_is_classifier("cuda")`` with
    ``GGAN_INCEPTION_PB`` naming the file and ``tools/score_samples.py
    --classifier frozen`` on a full-width cifar10 wali-gp checkpoint, both
    through the frozen head on the card. ``frozen_out`` keeps the graph's
    nodes and the card's classifier for ``phase_frozen_parity``."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.core.config import gan_inference_defaults
    from graphical_gan_tpu_torch.metrics import inception
    from graphical_gan_tpu_torch.metrics.graphdef import load_graphdef
    from graphical_gan_tpu_torch.metrics.inception_frozen import (
        FrozenInceptionClassifier)
    from graphical_gan_tpu_torch.models.gan_inference import (
        GanInferenceModel)
    from graphical_gan_tpu_torch.tools import score_samples
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    base = _frozen_dir()
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    pb = os.path.join(base, "classify_image_graph_def.pb")
    t0 = time.perf_counter()
    data = inception_v3_2015_graphdef(seed=0)
    with open(pb, "wb") as f:
        f.write(data)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    nodes = load_graphdef(pb)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf = FrozenInceptionClassifier(nodes, device="cuda")
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    count = frozen_flops(nodes, FROZEN_BATCH)
    consts = sum(v.numel() * v.element_size()
                 for v in clf.interp.consts.values())
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(FROZEN_BATCH, FROZEN_HW, FROZEN_HW, 3)
                         .astype(np.float32) * 255).cuda()
    t0 = time.perf_counter()
    pool, probs = clf.pool3_and_probs(x)  # picks cuDNN's algorithms
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    misses = []
    if tuple(probs.shape) != (FROZEN_BATCH, 1008) or \
            not bool(torch.isfinite(probs).all()) or \
            not bool(torch.isfinite(pool).all()):
        misses.append(f"outputs {tuple(probs.shape)} not finite")
    elif abs(float(probs.sum(dim=1).max()) - 1.0) > 1e-5:
        misses.append("probabilities do not sum to 1")
    def windows():
        """ms per batch in 3 CUDA-event windows of FROZEN_TIME_CALLS."""
        clf.pool3_and_probs(x)
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(FROZEN_TIME_CALLS):
                clf.pool3_and_probs(x)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / FROZEN_TIME_CALLS)
        return out

    ms = windows()
    batch_ms = statistics.median(ms)
    # readings: cuDNN free to choose non-deterministic algorithms, and the
    # device time by kernel group under the profiler
    torch.backends.cudnn.deterministic = False
    try:
        ms_free = statistics.median(windows())
    finally:
        torch.backends.cudnn.deterministic = True
    busy, groups, top, kernels_per_call = _profile(
        lambda _, xx: clf.pool3_and_probs(xx), x)
    nbytes = consts + x.numel() * 4 + FROZEN_BATCH * 1008 * 4
    bound_ms, bound_by = bound(count["flops"], nbytes, "float32")
    rec = {"phase": "frozen-inception", "batch": FROZEN_BATCH,
           "image_hw": FROZEN_HW, "nodes": len(nodes),
           "conv2d": count["n_conv"], "consts_mb": round(consts / 1e6, 3),
           "graph_mb": round(len(data) / 1e6, 3),
           "flops_per_image": count["flops"] / FROZEN_BATCH,
           "ms_per_batch": batch_ms, "ms_windows": ms,
           "images_per_s": FROZEN_BATCH / batch_ms * 1e3,
           "ms_per_batch_cudnn_nondeterministic": ms_free,
           "busy_share": busy, "device_ms_by_group": groups,
           "kernels_per_call_by_group": kernels_per_call,
           "top_kernels_ms": top,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / batch_ms,
           "bound_images_per_s": FROZEN_BATCH / bound_ms * 1e3,
           "write_s": t_write, "parse_s": t_parse, "upload_s": t_upload,
           "first_call_s": t_first,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(rec)
    frozen_out.update(nodes=nodes, clf=clf, rec=rec)

    # the two entries that pick the frozen head
    prev = os.environ.get("GGAN_INCEPTION_PB")
    os.environ["GGAN_INCEPTION_PB"] = pb
    try:
        with _FrozenCalls() as seen:
            t0 = time.perf_counter()
            hook_clf = inception.default_is_classifier("cuda")
            if not isinstance(hook_clf, FrozenInceptionClassifier) or \
                    hook_clf.device.type != "cuda":
                misses.append(f"default_is_classifier gave {hook_clf!r}")
            got = hook_clf(x[:10].cpu().numpy())
            if not np.allclose(got, probs[:10].cpu().numpy(), rtol=0,
                               atol=1e-6):
                misses.append("default_is_classifier's probabilities")
            del hook_clf
            t_hook = time.perf_counter() - t0
            model = GanInferenceModel(gan_inference_defaults("cifar10",
                                                             "wali-gp"))
            ckpt = save_params(os.path.join(base, "ckpt_0.npz"),
                               model.init(0, "cuda"), {"iteration": 0})
            t0 = time.perf_counter()
            score, got_l = _path_launches(
                score_samples.main, ["--ckpt", ckpt] + FROZEN_SCORE_ARGS
                + ["--classifier", "frozen", "--classifier-ckpt", pb])
            t_score = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("GGAN_INCEPTION_PB")
        else:
            os.environ["GGAN_INCEPTION_PB"] = prev
    _add(launch_totals, got_l)
    if score["classifier"] != f"frozen-inception-2015:{pb}" or \
            not math.isfinite(score["inception_score"]):
        misses.append(f"score_samples: {score}")
    # 1 call from the hook, one per IS batch from the tool
    want_calls = 1 + -(-score["n_samples"] // _clf_batch_sizes()[2])
    if seen.calls != {"cuda": want_calls}:
        misses.append(f"frozen head calls {seen.calls}, want "
                      f"{{'cuda': {want_calls}}}")
    missing = [k for k in ("bn_stats", "bn_apply") if not got_l.get(k)]
    if missing:
        misses.append(f"score_samples' generator launched no {missing}")
    log({"check": "frozen head through the entries",
         "default_is_classifier_s": t_hook, "score_samples_s": t_score,
         "score": score, "frozen_calls": seen.calls, "launches": got_l,
         "misses": misses})
    if misses:
        fail(f"frozen-inception: {misses}")


def phase_frozen_parity(frozen_out):
    """``pool_3`` and the probabilities of the card's classifier against
    the same graph's classifier on the CPU, FROZEN_PARITY_N images, TF32
    off on the card (relative L2 within FROZEN_POOL_REL_L2 and
    FROZEN_PROB_REL_L2)."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.metrics.inception_frozen import (
        FrozenInceptionClassifier)
    x = torch.from_numpy(np.random.RandomState(2).rand(
        FROZEN_PARITY_N, FROZEN_HW, FROZEN_HW, 3).astype(np.float32) * 255)
    cpu = FrozenInceptionClassifier(frozen_out["nodes"], device="cpu")
    want_pool, want = cpu.pool3_and_probs(x)
    got_pool, got = (t.cpu() for t in frozen_out["clf"].pool3_and_probs(
        x.cuda()))

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    rec = {"check": "frozen-inception card vs CPU", "n": FROZEN_PARITY_N,
           "pool_3_rel_l2": rel(got_pool, want_pool),
           "pool_3_bound": FROZEN_POOL_REL_L2,
           "probs_rel_l2": rel(got, want), "probs_bound": FROZEN_PROB_REL_L2,
           "probs_max_abs": float((got - want).abs().max()),
           "tf32": torch.backends.cudnn.allow_tf32}
    log(rec)
    if not (rec["pool_3_rel_l2"] <= FROZEN_POOL_REL_L2
            and rec["probs_rel_l2"] <= FROZEN_PROB_REL_L2) or rec["tf32"]:
        fail(f"frozen-inception parity: {rec}")


def phase_quality_run(launch_totals):
    """``tools/quality_run.py`` at the published cifar10 wali-gp width in
    bf16 and f32, QUALITY_ITERS iterations and QUALITY_SAMPLES metric
    samples each: both records finite, with the JAX tool's keys, and the
    training kernels launched. It runs beside the side phases: its
    throughput is read beside them."""
    import numpy as np
    from graphical_gan_tpu_torch.tools import quality_run
    base = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                        "smoke_quality")
    shutil.rmtree(base, ignore_errors=True)
    recs, got = _path_launches(quality_run.main, [
        "--iters", str(QUALITY_ITERS), "--n-metric-samples",
        str(QUALITY_SAMPLES), "--outdir", base])
    _add(launch_totals, got)
    misses = []
    for rec in recs:
        log({"phase": "quality-run", **rec})
        if set(rec) != QUALITY_KEYS:
            misses.append(f"{rec['dtype']} keys {sorted(rec)}")
        finite = [rec["fid_vs_train"], rec["train_throughput_img_per_sec"]] \
            + list(rec["hermetic_is"]) + list(rec["disc_cost_windows"]) \
            + list(rec["final"].values())
        if not (rec["params_finite"] and rec["losses_finite"]
                and np.isfinite(finite).all()):
            misses.append(f"{rec['dtype']} not finite")
    if [r["dtype"] for r in recs] != ["bfloat16", "float32"]:
        misses.append(f"dtypes {[r['dtype'] for r in recs]}")
    missing = [k for k in TRAIN_KERNELS if not got.get(k)]
    if missing:
        misses.append(f"kernels never launched {missing}")
    log({"check": "quality-run", "launches": got, "misses": misses})
    if misses:
        fail(f"quality-run: {misses}")


def quality_run_batches() -> tuple:
    """The metric classifier's batch sizes in ``phase_quality_run``: the
    feature passes over QUALITY_SAMPLES rows and the IS batches."""
    _, _, is_b = _clf_batch_sizes()
    return tuple(sorted({QUALITY_SAMPLES} | _batches_of(QUALITY_SAMPLES,
                                                        is_b)))


def _check_quality_run(gen, errs, misses, seen):
    """K1 and K2a/K2b at the shapes only ``phase_quality_run`` gives them:
    its metric classifier (JAX's default width 64, f32, cifar10) and G's BN
    where its bf16 model samples (f32 is in ``_check_classifier``)."""
    import torch
    from graphical_gan_tpu_torch.metrics.classifier import MetricClassifier
    from graphical_gan_tpu_torch.tools.quality_run import _draw_samples
    dim = _default(MetricClassifier.__init__, "dim")
    batches = quality_run_batches()
    log({"check": "quality-run batches", "B": list(batches), "dim": dim})
    for b in batches:
        conv, bn = classifier_shapes(b, 32, 3, dim)
        for name, shape, cout, act in conv:
            x, w, bias = _conv_inputs(shape, cout, torch.float32, gen, 3)
            _check_conv(f"{name} dim {dim} B={b}", x, w, bias, 2, "SAME",
                        act, errs, misses, seen)
        for name, rc, act in bn:
            x, scale, offset = _bn_inputs(rc, torch.float32, gen)
            _check_bn(f"{name} dim {dim} B={b}", x, scale, offset, act, 0.0,
                      errs, misses)
    b = _default(_draw_samples, "batch")
    for name, rc, act in bn_shapes(b):
        if name.startswith("G."):
            x, scale, offset = _bn_inputs(rc, torch.bfloat16, gen)
            _check_bn(f"{name} bf16 sample B={b}", x, scale, offset, act,
                      0.0, errs, misses)


def _library_cases():
    """(label, specs, fn(params, *inputs), inputs) of the part-B ops at
    small shapes; parameters from ``init_params`` (seed 0, CPU), inputs
    from a numpy seed."""
    import numpy as np
    import torch
    from graphical_gan_tpu_torch.objectives import gan as gan_objs
    from graphical_gan_tpu_torch.objectives import gan_inference as gi
    from graphical_gan_tpu_torch.ops import conv, layout, norm, special
    from graphical_gan_tpu_torch.ops.linear import linear, linear_specs
    rng = np.random.RandomState(0)

    def arr(*shape, shift=0.0):
        return torch.from_numpy(np.asarray(rng.randn(*shape) + shift,
                                           np.float32))

    moving = (arr(16), arr(16).abs() + 0.5)
    labels = torch.from_numpy(rng.randint(0, 5, 8))
    cases = [
        ("batchnorm_moving_stats train", norm.batchnorm_specs("bn", 16),
         lambda p, x, m, v: norm.batchnorm_moving_stats(
             p, "bn", x, True, 3, m, v), (arr(8, 6, 6, 16, shift=0.5),)
         + moving),
        ("batchnorm_moving_stats inference", norm.batchnorm_specs("bn", 16),
         lambda p, x, m, v: norm.batchnorm_moving_stats(
             p, "bn", x, False, 3, m, v), (arr(8, 6, 6, 16),) + moving),
        ("layernorm", norm.layernorm_specs("ln", 16),
         lambda p, x: norm.layernorm(p, "ln", [1, 2, 3], x),
         (arr(8, 16, 5, 5),)),
        ("cond_batchnorm", norm.cond_batchnorm_specs("cbn", 5, 16),
         lambda p, x: norm.cond_batchnorm(p, "cbn", x, labels.to(x.device),
                                          5), (arr(8, 6, 6, 16),)),
        ("minibatch_layer", special.minibatch_specs("mb", 64, 8, 5),
         lambda p, x: special.minibatch_layer(p, "mb", x),
         (arr(16, 64) * 0.05,)),
        ("ladder", special.ladder_specs("lad", 32),
         lambda p, z, u: special.ladder(p, "lad", (z, u)),
         (arr(8, 32), arr(8, 32))),
        ("linear weightnorm orthogonal",
         linear_specs("l", 64, 64, initialization="orthogonal",
                      weightnorm=True),
         lambda p, x: linear(p, "l", x, weightnorm=True),
         (arr(8, 64),)),
        ("conv2d mask a, weightnorm, no bias",
         conv.conv2d_specs("c", 64, 64, 5, mask_type=("a", 3),
                           weightnorm=True, biases=False),
         lambda p, x: conv.conv2d(p, "c", x, 1, "SAME", "leaky_relu",
                                  ("a", 3), True, False),
         (arr(8, 16, 16, 64),)),
        ("conv2d mask b, stride 2", conv.conv2d_specs(
            "c", 32, 64, 3, mask_type=("b", 1), stride=2),
         lambda p, x: conv.conv2d(p, "c", x, 2, "SAME", None, ("b", 1)),
         (arr(8, 16, 16, 32),)),
        ("conv1d mask b, weightnorm", conv.conv1d_specs(
            "c", 32, 48, 5, mask_type=("b", 2), weightnorm=True),
         lambda p, x: conv.conv1d(p, "c", x, 1, ("b", 2), True),
         (arr(8, 40, 32),)),
        ("wgan", {}, lambda p, f, r: gan_objs.wgan(f, r),
         (arr(64, 1), arr(64, 1))),
        ("wgan_gp", {}, lambda p, f, r, g: gan_objs.wgan_gp(f, r, g),
         (arr(64, 1), arr(64, 1), arr().abs())),
        ("gan", {}, lambda p, f, r: gan_objs.gan(f, r),
         (arr(64, 1), arr(64, 1))),
        ("local_ep_dynamic 0 zz", {},
         lambda p, f, r: gi.local_ep_dynamic([], [], f, r),
         (arr(64, 1), arr(64, 1))),
        ("local_ep_dynamic 2 zz", {},
         lambda p, a, b, c, d, f, r, rec: gi.local_ep_dynamic(
             [a, b], [c, d], f, r, rec),
         tuple(arr(64, 1) for _ in range(6)) + (arr().abs(),)),
        ("nchw_to_nhwc", {}, lambda p, x: layout.nchw_to_nhwc(x),
         (arr(4, 3, 8, 8),)),
    ]
    for k in (3, 4, 5):
        for s in (1, 2):
            cases.append((
                f"deconv2d VALID k{k} s{s}", conv.deconv2d_specs(
                    "d", 32, 16, k, weightnorm=(k + s) % 2 == 0,
                    biases=k != 4, stride=s),
                lambda p, x, k=k, s=s: conv.deconv2d(
                    p, "d", x, s, "VALID", (k + s) % 2 == 0, k != 4),
                (arr(8, 7, 7, 32),)))
    return cases


def _library_run(fn, params, inputs, device):
    """Outputs and the gradients of sum(out * c) w.r.t. the parameters and
    float inputs, on ``device``; c is a fixed random cotangent per output
    (a constant one would leave a normalization's input gradient at 0,
    rounding noise only)."""
    import torch
    p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    xs = [x.to(device).requires_grad_(x.is_floating_point())
          for x in inputs]
    outs = fn(p, *xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    leaves = list(p.values()) + [x for x in xs if x.requires_grad]
    gen = torch.Generator().manual_seed(1)
    total = sum((o.float() * torch.randn(o.shape, generator=gen).to(device))
                .sum() for o in outs if o.requires_grad)
    grads = torch.autograd.grad(total, leaves, allow_unused=True) \
        if leaves and isinstance(total, torch.Tensor) else ()
    return ([o.detach().cpu() for o in outs],
            [g.cpu() for g in grads if g is not None])


def phase_library_ops(launch_totals):
    """Each op of ``_library_cases`` on the card against its CPU run
    (outputs within LIB_RTOL with LIB_ATOL_REL of the largest magnitude,
    gradients within GRAD_RTOL relative L2), the conv2d cases' K1
    launches counted from zero; and
    ``epoch_batches_ondevice`` on the card, a permutation without
    replacement."""
    import torch
    from graphical_gan_tpu_torch.data.ondevice import epoch_batches_ondevice
    from graphical_gan_tpu_torch.ops import initializers
    from graphical_gan_tpu_torch.ops import kernels
    misses, worst, grad_l2 = [], {}, {}
    kernels.reset_launches()
    for label, specs, fn, inputs in _library_cases():
        params = initializers.init_params(specs, 0, "cpu")
        want_out, want_grads = _library_run(fn, params, inputs, "cpu")
        got_out, got_grads = _library_run(fn, params, inputs, "cuda")
        if [t.shape for t in got_out + got_grads] != \
                [t.shape for t in want_out + want_grads]:
            misses.append(f"{label}: shapes differ")
            continue
        err, l2 = 0.0, 0.0
        for g, w in zip(got_out, want_out):
            scale = float(w.abs().max()) if w.numel() else 0.0
            diff = (g - w).abs()
            if bool((diff > LIB_RTOL * w.abs() + LIB_ATOL_REL * scale).any()):
                misses.append(f"{label}: output")
            if w.numel():
                err = max(err, float(diff.max()) / max(scale, 1e-30))
        for k, (g, w) in enumerate(zip(got_grads, want_grads)):
            rel = float(torch.linalg.vector_norm(g - w)
                        / max(float(torch.linalg.vector_norm(w)), 1e-30))
            if not rel <= GRAD_RTOL:
                misses.append(f"{label}: gradient {k}")
            l2 = max(l2, rel)
        worst[label], grad_l2[label] = err, l2
    got_l = kernels.launches()
    _add(launch_totals, got_l)
    data = torch.arange(1000, device="cuda").reshape(100, 10)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ep = epoch_batches_ondevice(data, 16, gen)
    rows = (ep[..., 0] // 10).flatten().tolist()
    if tuple(ep.shape) != (6, 16, 10) or len(set(rows)) != 96:
        misses.append(f"epoch_batches_ondevice {tuple(ep.shape)}")
    if not got_l.get("fused_conv2d_bias_act"):
        misses.append("K1 never launched by the conv2d cases")
    log({"check": "library-ops card vs CPU", "cases": len(worst),
         "output_max_rel_err": worst, "rtol": LIB_RTOL,
         "atol_of_max": LIB_ATOL_REL, "grad_rel_l2": grad_l2,
         "grad_rtol": GRAD_RTOL, "launches": got_l, "misses": misses})
    if misses:
        fail(f"library-ops: {misses}")


# ---------------------------------------------------------------------------
# parallelism: K2a's and K2c+K2d's split modes, the int8 transposed conv at
# every stride and padding, and the strategies over torch.distributed

# the split modes' kernels: K2a's statistics of one rank's rows (one
# cluster launch, written into the rank's slot of the exchange buffer), K2b
# with K2a's finalize over the ranks' triples folded in (and its int8 form,
# for the dp int8 server), K2c's sums of one rank's rows (one cluster
# launch, into the rank's slot of the backward's exchange buffer) and K2d
# with the ranks' sums added in rank order folded in
SPLIT_SOURCES = {
    "bn_stats_local": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                       "graphical_gan_tpu/ops/pallas/fused_norm.py:143"),
    "bn_apply_split": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                       "graphical_gan_tpu/ops/pallas/fused_norm.py:143, "
                       "graphical_gan_tpu/ops/pallas/fused_norm.py:182"),
    "bn_apply_split_q8": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                          "graphical_gan_tpu/ops/pallas/fused_norm.py:182, "
                          "graphical_gan_tpu/ops/quant.py:103"),
    "bn_bwd_local": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                     "graphical_gan_tpu/ops/pallas/fused_norm.py:212"),
    "bn_bwd_apply_split": ("graphical_gan_tpu_torch/csrc/fused_norm.cu",
                           "graphical_gan_tpu/ops/pallas/fused_norm.py:223"),
}
SPLIT_KERNELS = tuple(SPLIT_SOURCES)
SPLIT_RANKS = 2         # the ranks the training batch is split over
SPLIT_WORLDS = (2, 4)   # the rank counts the split kernels are held at
SPLIT_B = 64            # the published global batch
# bn_stats_local against its plain version: f64 sums in other orders, each
# value within 1e-9 of 1 + |value|
LOCAL_RTOL = 1e-9


def _split_bounds(r: int, c: int, itemsize: int, ranks: int):
    """(bound ms, what bounds it) of each split kernel over one rank's r
    rows of [*, c]: local reads x once and writes the [ranks, 3, C] f64
    exchange buffer; apply_split reads x, scale, offset and the ranks'
    triples once and writes y and the [3, C] f32 statistics (K2b's bytes
    with the statistics written in place of mean and inv read, plus the
    triples), q8 also writes y's int8 copy; bwd_local reads g, x and the
    four per-channel vectors once and writes the [ranks, 2, C] f32
    exchange buffer; bwd_apply_split reads g, x, the vectors and the
    ranks' sums once (its blocks read the sums again per row range; the
    bound counts them once) and writes dx. Operations as the one-launch
    kernels count them (bn_stats_bound, bn_bwd_bound), split between the
    phases, about 10 f64 operations a rank and channel for a merge, and 2
    f32 adds a rank and channel for the sums' rank-order sum."""
    trip = ranks * 3 * c * 8
    merge = 10.0 * ranks * c
    sums = ranks * 2 * c * 4
    return {
        "bn_stats_local": bound(3.0 * r * c, r * c * itemsize + trip,
                                "float32"),
        "bn_apply_split": bound(4.0 * r * c + merge, 2 * r * c * itemsize
                                + 5 * c * 4 + trip, "float32"),
        "bn_apply_split_q8": bound(6.0 * r * c + merge, r * c * (
            2 * itemsize + 1) + 5 * c * 4 + trip, "float32"),
        "bn_bwd_local": bound(10.0 * r * c, 2 * r * c * itemsize
                              + 4 * c * 4 + sums, "float32"),
        "bn_bwd_apply_split": bound(14.0 * r * c + 2.0 * ranks * c,
                                    3 * r * c * itemsize + 4 * c * 4 + sums,
                                    "float32"),
    }


def _library_ms(name, fn, args):
    """time_ms of one PyTorch call that computes a kernel's function (its
    yardstick), or None, logged with the reason, where this PyTorch
    refuses the inputs."""
    try:
        fn(*args)
    except (RuntimeError, TypeError, ValueError) as e:
        log({"library_refused": name, "error": str(e)[:300]})
        return None
    return time_ms(fn, args)


def _library_moments(xs):
    """The ranks' (mean [W, C], invstd [W, C], count [W]) as
    ``torch.batch_norm_stats`` gives them, the inputs of
    ``torch.batch_norm_gather_stats_with_counts``, or None where this
    PyTorch refuses the inputs."""
    import torch
    try:
        got = [torch.batch_norm_stats(p, 1e-5) for p in xs]
    except (RuntimeError, TypeError) as e:
        log({"library_refused": "torch.batch_norm_stats",
             "error": str(e)[:300]})
        return None
    # the counts in the input's dtype, as the call asks (exact: the rows
    # a rank holds here are powers of two up to 8,192)
    return (torch.stack([m for m, _ in got]),
            torch.stack([v for _, v in got]),
            torch.tensor([float(p.shape[0]) for p in xs], device="cuda",
                         dtype=xs[0].dtype))


def _split_forward(fn, x, xs, scale, offset, act, s_x, label, worst,
                   misses):
    """K2a's split mode over ``xs``, one part a rank: each rank's
    ``bn_stats_local`` in its slot (two calls the same bits, the other
    slots zero, the triple within LOCAL_RTOL of its plain version), the
    slots summed as the all_reduce sums them, then on every rank's rows
    ``bn_apply_split``: its [3, C] against ``bn_stats_merge_plain`` and
    the whole batch's plain statistics within TOL["stats"], the same on
    every rank and from two calls, y bit for bit K2b's (``bn_apply``) at
    those statistics, and ``bn_apply_split_q8``'s y and int8 copy bit for
    bit ``bn_apply_q8``'s. Returns (the gathered triples, the
    statistics)."""
    import torch
    w = len(xs)
    dn = str(x.dtype).split(".")[1]
    bufs = [fn.bn_stats_local(p, i, w) for i, p in enumerate(xs)]
    if not torch.equal(bufs[0], fn.bn_stats_local(xs[0], 0, w)):
        misses.append(f"{label}: bn_stats_local differs between two calls")
    for i, (p, buf) in enumerate(zip(xs, bufs)):
        if bool(torch.cat([buf[:i], buf[i + 1:]]).ne(0).any()):
            misses.append(f"{label}: rank {i}'s other slots are not zero")
        want = fn.bn_stats_local_plain(p)
        d = float(((buf[i] - want).abs() / (1.0 + want.abs())).max())
        worst["bn_stats_local"] = max(worst["bn_stats_local"], d)
        if not d <= LOCAL_RTOL:
            misses.append(f"{label}: bn_stats_local {d}")
    parts = torch.stack(bufs).sum(0)  # one non-zero term per slot: exact
    atol, rtol = TOL[("stats", dn)]
    stats = None
    for i, p in enumerate(xs):
        y, st = fn.bn_apply_split(p, parts, scale, offset, act)
        if stats is None:
            stats = st
            y2, st2 = fn.bn_apply_split(p, parts, scale, offset, act)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                misses.append(f"{label}: bn_apply_split differs between "
                              "two calls")
            e, bad = max_err(st, fn.bn_stats_merge_plain(parts), atol, rtol)
            e2, bad2 = max_err(st, torch.stack(fn.bn_stats_plain(x)), atol,
                               rtol)
            for k in ("bn_apply_split", "bn_apply_split_q8"):
                worst[k] = max(worst[k], e)
            if bad or bad2:
                misses.append(f"{label}: bn_apply_split's statistics {e}, "
                              f"against the whole batch {e2}")
        elif not torch.equal(st, stats):
            misses.append(f"{label}: rank {i}'s statistics differ")
        if not torch.equal(y, fn.bn_apply(p, stats[0], stats[2], scale,
                                          offset, act)):
            misses.append(f"{label}: rank {i}'s y is not K2b's")
        yq, q, _ = fn.bn_apply_split_q8(p, parts, scale, offset, act, s_x)
        wy, wq = fn.bn_apply_q8(p, stats[0], stats[2], scale, offset, act,
                                s_x)
        if not (torch.equal(yq, wy) and torch.equal(q, wq)):
            misses.append(f"{label}: rank {i}'s y or int8 copy is not "
                          "bn_apply_q8's")
    return parts, stats


def _split_backward(fn, g, x, gs, xs, stats, scale, offset, act, rows,
                    label, worst, misses):
    """K2c+K2d's split mode at the forward's statistics over ``xs``, one
    part a rank: each rank's ``bn_bwd_local`` in its slot (two calls the
    same bits, the other slots +0, the sums within RED_RTOL of each
    channel's mass of its plain version), the slots summed as the
    all_reduce sums them, then on every rank's rows ``bn_bwd_apply_split``
    (two calls the same bits, within TOL["bwd_apply"] of its plain
    version: the rank-order sum, then ``bn_bwd_apply_plain``),
    and the ranks' dx against the plain backward over the whole batch.
    Returns the gathered sums."""
    import torch
    dn = str(x.dtype).split(".")[1]
    mean, inv = stats[0], stats[2]
    w = len(xs)
    bufs = [fn.bn_bwd_local(gp, xp, mean, inv, scale, offset, i, w, act)
            for i, (gp, xp) in enumerate(zip(gs, xs))]
    if not torch.equal(bufs[0], fn.bn_bwd_local(
            gs[0], xs[0], mean, inv, scale, offset, 0, w, act)):
        misses.append(f"{label}: bn_bwd_local differs between two calls")
    for i, (gp, xp, buf) in enumerate(zip(gs, xs, bufs)):
        others = torch.cat([buf[:i], buf[i + 1:]])
        if bool(others.view(torch.int32).ne(0).any()):
            misses.append(f"{label}: rank {i}'s other slots are not +0")
        want = fn.bn_bwd_reduce_plain(gp, xp, mean, inv, scale, offset, act)
        gz, xhat = fn._gz_xhat(gp, xp, mean, inv, scale, offset, act)
        mag = torch.stack([gz.abs().sum(0), (gz * xhat).abs().sum(0)])
        d = float(((buf[i] - want).abs() / (1.0 + mag)).max())
        worst["bn_bwd_local"] = max(worst["bn_bwd_local"], d)
        if not d <= RED_RTOL:
            misses.append(f"{label}: bn_bwd_local {d}")
    sums = torch.stack(bufs).sum(0)  # one non-zero term per slot: exact
    dxs = [fn.bn_bwd_apply_split(gp, xp, mean, inv, scale, offset, sums,
                                 rows, act) for gp, xp in zip(gs, xs)]
    if not torch.equal(dxs[0], fn.bn_bwd_apply_split(
            gs[0], xs[0], mean, inv, scale, offset, sums, rows, act)):
        misses.append(f"{label}: bn_bwd_apply_split differs between two "
                      "calls")
    atol, rtol = TOL[("bwd_apply", dn)]
    for gp, xp, got in zip(gs, xs, dxs):
        want = fn.bn_bwd_apply_split_plain(gp, xp, mean, inv, scale, offset,
                                           sums, rows, act)
        e, bad = max_err(got, want, atol, rtol)
        worst["bn_bwd_apply_split"] = max(worst["bn_bwd_apply_split"], e)
        if bad:
            misses.append(f"{label}: bn_bwd_apply_split {e}")
    whole_dx, _ = fn.bn_bwd_plain(g, x, mean, inv, scale, offset, act)
    e, bad = max_err(torch.cat(dxs), whole_dx, atol, rtol)
    if bad:
        misses.append(f"{label}: the split backward against the whole "
                      f"batch {e}")
    return sums


def phase_split_kernels(errs, timings, card):
    """K2a's and K2c+K2d's split modes at the training BN shapes of B=64
    split over the ranks of SPLIT_WORLDS (each rank's rows one part), f32
    and bf16. At each world size the forward (``_split_forward``: the
    rank's statistics in its slot, the finalize folded into K2b and its
    int8 form, bit for bit with the one-launch K2b at those statistics)
    and the backward (``_split_backward``: the rank's sums in its slot,
    the rank-order sum folded into K2d). Time, at one rank's rows: each
    kernel beside its plain version and its library call
    (``torch.batch_norm_stats`` for the rank's statistics, with
    ``torch.var_mean`` as a second reading; ``torch.
    batch_norm_gather_stats_with_counts`` over the ranks' (mean, invstd,
    count) for the finalize folded into the apply; ``torch.
    batch_norm_backward_reduce`` and ``batch_norm_backward_elemt`` on gz =
    g·act'(y), the mask applied first, for the backward's two), the split
    forward chain (``chain_ms``: the rank's statistics, then the apply)
    and backward chain (``bwd_chain_ms``: the rank's sums, then dx; the
    all_reduce between them is not timed in either), and the one-launch
    K2a and K2c+K2d over the whole batch as readings (what world size 1
    runs)."""
    import torch
    from graphical_gan_tpu_torch.ops.kernels import fused_norm as fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    worst = {k: 0.0 for k in SPLIT_KERNELS}
    misses = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for name, rc, act in bn_shapes(SPLIT_B):
            x, scale, offset = _bn_inputs(rc, dtype, gen, mean=3.0)
            g = torch.randn(rc, generator=gen, device="cuda").to(dtype)
            mean_w, _, inv_w = fn.bn_stats_plain(x)
            y_w = fn.bn_apply_plain(x, mean_w, inv_w, scale, offset, act)
            s_x = max(float(y_w.float().abs().max()), 1e-6) / 127.0
            one = {"bn_stats_one_launch_ms": time_ms(
                       lambda a: fn.bn_stats(a), [x])}
            for ranks in SPLIT_WORLDS:
                label = f"{name} {dn} W={ranks}"
                xs = x.chunk(ranks)
                r_part = xs[0].shape[0]
                parts, stats = _split_forward(fn, x, xs, scale, offset, act,
                                              s_x, label, worst, misses)
                x0 = xs[0]
                bounds = _split_bounds(r_part, rc[1], dtype.itemsize, ranks)
                moments = _library_moments(xs)
                # name: (kernel, plain version, library call and its
                # arguments or None, arguments, more readings)
                t = {
                    "bn_stats_local": (
                        lambda a: fn.bn_stats_local(a, 0, ranks),
                        lambda a: fn.bn_stats_local_plain(a, 0, ranks),
                        (lambda a: torch.batch_norm_stats(a, fn.EPS), [x0]),
                        [x0],
                        {"library_var_mean_ms": _library_ms(
                            "torch.var_mean",
                            lambda a: torch.var_mean(a.float(), dim=0,
                                                     correction=0), [x0])}),
                    "bn_apply_split": (
                        lambda a: fn.bn_apply_split(a, parts, scale, offset,
                                                    act),
                        lambda a: fn.bn_apply_split_plain(a, parts, scale,
                                                          offset, act),
                        None, [x0],
                        {"library_finalize_ms": None if moments is None
                         else _library_ms(
                             "torch.batch_norm_gather_stats_with_counts",
                             lambda a, m, v, n: torch.
                             batch_norm_gather_stats_with_counts(
                                 a, m, v, None, None, 0.1, fn.EPS, n),
                             [x0, *moments]),
                         "chain_ms": time_ms(
                             lambda a: (fn.bn_stats_local(a, 0, ranks),
                                        fn.bn_apply_split(a, parts, scale,
                                                          offset, act)),
                             [x0]),
                         # the one-launch K2b at the same rows and stats
                         "k2b_ms": time_ms(
                             lambda a: fn.bn_apply(a, stats[0], stats[2],
                                                   scale, offset, act),
                             [x0])}),
                    "bn_apply_split_q8": (
                        lambda a: fn.bn_apply_split_q8(a, parts, scale,
                                                       offset, act, s_x),
                        lambda a: fn.bn_apply_split_q8_plain(
                            a, parts, scale, offset, act, s_x), None, [x0],
                        {}),
                }
                gs = g.chunk(ranks)
                sums = _split_backward(fn, g, x, gs, xs, stats, scale,
                                       offset, act, rc[0], label, worst,
                                       misses)
                mean, inv = stats[0], stats[2]
                g0 = gs[0]
                gz0 = fn._gz_xhat(g0, x0, mean, inv, scale, offset,
                                  act)[0].to(dtype)
                red = sums.sum(0)  # the ranks' sums (the library's input)
                sum_dy, sum_dy_xmu = red[0], red[1] / inv
                n_all = torch.full((ranks,), r_part, dtype=torch.int32,
                                   device="cuda")
                # the library's backward calls take gz, the mask applied
                # beforehand
                t["bn_bwd_local"] = (
                    lambda a, b: fn.bn_bwd_local(a, b, mean, inv, scale,
                                                 offset, 0, ranks, act),
                    lambda a, b: fn.bn_bwd_local_plain(
                        a, b, mean, inv, scale, offset, 0, ranks, act),
                    (lambda a, b: torch.batch_norm_backward_reduce(
                        a, b, mean, inv, scale, True, True, True),
                     [gz0, x0]), [g0, x0], {})
                t["bn_bwd_apply_split"] = (
                    lambda a, b: fn.bn_bwd_apply_split(
                        a, b, mean, inv, scale, offset, sums, rc[0], act),
                    lambda a, b: fn.bn_bwd_apply_split_plain(
                        a, b, mean, inv, scale, offset, sums, rc[0], act),
                    (lambda a, b: torch.batch_norm_backward_elemt(
                        a, b, mean, inv, scale, sum_dy, sum_dy_xmu, n_all),
                     [gz0, x0]), [g0, x0],
                    {"bwd_chain_ms": time_ms(
                        lambda a, b: fn.bn_bwd_apply_split(
                            a, b, mean, inv, scale, offset,
                            fn.bn_bwd_local(a, b, mean, inv, scale, offset,
                                            0, ranks, act), rc[0], act),
                        [g0, x0])})
                if ranks == SPLIT_RANKS:
                    one["bn_bwd_one_launch_ms"] = time_ms(
                        lambda a, b: fn.bn_bwd(a, b, mean, inv, scale,
                                               offset, act), [g, x])
                for kname, (kern, plain, lib, args, extra) in t.items():
                    t_b, by = bounds[kname]
                    row = {"kernel": kname, "shape": name, "B": SPLIT_B,
                           "rank_rows": r_part, "ranks": ranks,
                           "dtype": dn, "card": card,
                           "ms": time_ms(kern, args),
                           "plain_ms": time_ms(plain, args, 3, 5),
                           "library_ms": None if lib is None
                           else _library_ms(kname, *lib),
                           "bound_ms": t_b, "bound_by": by, **extra, **one}
                    timings.append(row)
                    log({"timing": row})
    errs.update(worst)
    log({"check": "K2a/K2c+K2d split modes", "worlds": list(SPLIT_WORLDS),
         "backward_ranks": SPLIT_RANKS, "max_err": worst,
         "misses": misses})
    if misses:
        fail(f"split kernels: {misses[:8]}")


# (input NHWC, O, k) of cifar10's G deconvs at the serving bucket 64, and
# the strides and paddings JAX's int8 intercept takes beyond stride 2 SAME
INT8_DECONV_SHAPES = (((64, 4, 4, 256), 128, 5), ((64, 8, 8, 128), 64, 5))
INT8_DECONV_CASES = ((1, "SAME"), (1, "VALID"), (2, "VALID"), (3, "SAME"),
                     (3, "VALID"))


def _deconv_products(b, h, w, cin, cout, k, s, lo_h, lo_w, oh, ow):
    """The int8 products a transposed conv needs, 2 ops each: the taps of
    the stride-1 conv over the zero-dilated input that land on an input
    element (not on an inserted zero or in the padding)."""
    def axis(n_out, n_in, lo):
        span = (n_in - 1) * s + 1
        return sum(1 for o in range(n_out) for t in range(k)
                   if 0 <= o - lo + t < span and (o - lo + t) % s == 0)
    return 2.0 * b * axis(oh, h, lo_h) * axis(ow, w, lo_w) * cin * cout


def phase_int8_deconv(card, timings):
    """The int8 transposed conv at every stride and padding (ROADMAP fault
    4's repair, ``ops/quant.py: intercept_deconv2d``): at cifar10's G
    deconvs (bucket 64) for each of INT8_DECONV_CASES, in f32 and bf16, the
    intercept on the card bit-equal to the same intercept on the CPU (the
    plain versions), and its one Q2 call (the zero-dilated int8 input, the
    flipped HWIO filter, stride 1) twice against Q2's plain version
    (``_check_q2``); in f32, Q2's time on ``q2_plan``'s route beside its
    bound (the products the transposed conv needs, over the int8 peak, or
    bytes)."""
    import torch
    from graphical_gan_tpu_torch.ops import quant as tq
    from graphical_gan_tpu_torch.ops.kernels import quant as kq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    misses, worst = [], [0, 0.0]
    for shape, cout, k in INT8_DECONV_SHAPES:
        for stride, padding in INT8_DECONV_CASES:
            x = torch.randn(shape, generator=gen, device="cuda")
            w = 0.05 * torch.randn((k, k, cout, shape[-1]), generator=gen,
                                   device="cuda")
            bias = torch.randn((cout,), generator=gen, device="cuda")
            s_x = float(x.abs().max()) / 127.0
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                label = f"deconv {list(shape)} s{stride} {padding} {dn}"
                xd = x.to(dtype)
                with tq.quantized({"d": s_x}):
                    got = tq.intercept_deconv2d("d", xd, w, stride, padding,
                                                bias)
                with tq.quantized({"d": s_x}):
                    want = tq.intercept_deconv2d("d", xd.cpu(), w.cpu(),
                                                 stride, padding, bias.cpu())
                if not _same_bits(got.cpu(), want):
                    misses.append(f"{label}: card != CPU")
                s_w = tq.weight_scales(w, 2)
                wq = kq.quantize_int8(w.contiguous(), s_w.float(), axis=2)
                pf = kq.pack_filter(wq.flip(0, 1).permute(0, 1, 3, 2)
                                    .contiguous())
                factor = tq._factor(s_x, s_w)
                lo, hi = tq.conv_transpose_pads(k, stride, padding)
                xq = tq.dilate_rows_cols(kq.quantize_int8(xd, s_x), stride)
                pads = ((lo, hi), (lo, hi))
                e_sum, e_out, route = _check_q2(xq, pf, factor, 1, pads,
                                                dtype, bias, None, misses,
                                                label)
                worst[0] = max(worst[0], e_sum)
                worst[1] = max(worst[1], e_out)
                if dtype != torch.float32:
                    continue
                b, h, wd, cin = shape
                oh, ow = got.shape[1:3]
                ops = _deconv_products(b, h, wd, cin, cout, k, stride, lo,
                                       lo, oh, ow)
                nbytes = (b * h * wd * cin + k * k * cin * cout + 8 * cout
                          + b * oh * ow * cout * 4)
                t_ops = ops / card_peaks()[0]["int8"] * 1e3
                t_bytes = hbm_ms(nbytes)
                plan = _q2_plan_of(xq, pf, 1, pads)
                row = {"kernel": "int8_conv", "use": "int8 deconv",
                       "shape": [list(shape), cout, k], "stride": stride,
                       "padding": padding, "dtype": dn, "card": card,
                       "route": plan.route,
                       "plan": {kk: v for kk, v in plan.as_dict().items()
                                if kk in ("bm", "bn", "bk", "stages",
                                          "splits")},
                       "dilated_input": list(xq.shape),
                       "ms": time_ms(lambda a, wk: kq.int8_conv_packed(
                           a, pf._replace(wk=wk), factor, 1, pads, dtype,
                           bias), [xq, pf.wk], 5, 10),
                       "plain_ms": time_ms(lambda a: kq.int8_conv_plain(
                           a, kq.unpack_filter(pf), factor, 1, pads, dtype,
                           bias), [xq], 3, 3),
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "library_ms": None}
                timings.append(row)
                log({"timing": row})
    log({"check": "int8 deconv (every stride and padding)",
         "sums_max_abs_err": worst[0], "out_max_abs_err": worst[1],
         "misses": misses})
    if misses:
        fail(f"int8 deconv: {misses[:8]}")


def phase_parallel(launch_totals):
    """The strategies over torch.distributed on this card
    (``tools/parallel_check.py``): each of dp, tp, sp, ep and composed at
    world size 1 over NCCL bit for bit against the one-device step, then
    dp and tp (cifar10 wali-gp), ep (GMGAN mnist local_ep) and sp (SSGAN
    moving-MNIST local_ep, BN on) on 2 gloo ranks on cuda:0 at the
    published widths against the one-device step, replicas bit-identical.
    The launches of rank 0's strategy runs and of its dp server's
    dispatches (counts set to 0 just before each) are the split kernels'
    main path: a split BN forward is ``bn_stats_local`` and
    ``bn_apply_split`` (the server's int8 dispatch ``bn_apply_split_q8``)
    around one all_reduce, a split BN backward ``bn_bwd_local`` and
    ``bn_bwd_apply_split`` around one, so each pair counts alike; no
    finalize kernel and no rank-order sum is left to launch."""
    from graphical_gan_tpu_torch.tools import parallel_check
    out = os.path.join(ROOT, "graphical_gan_tpu_torch", "_build",
                       "parallel_check.json")
    try:
        doc = parallel_check.main(["--device", "cuda", "--out", out,
                                   "--timeout", "600"])
    except SystemExit:
        with open(out) as f:
            doc = json.load(f)
        fail(f"parallel: {doc['misses']}")
    ranks = doc["ranks"]
    sharded = {run: [c.get("sharded_resume_bit_identical")
                     for c in doc[run]["cases"] if c["strategy"] == "tp"]
               for run in ("world1", "ranks")}
    log({"phase": "parallel", "world1": [
        {k: c[k] for k in ("strategy", "mesh", "bit_identical", "seconds")}
        for c in doc["world1"]["cases"]],
         "ranks": [{k: c[k] for k in ("strategy", "mesh", "dataset",
                                      "batch_size", "misses", "sign_flips",
                                      "replicas_bit_identical", "seconds")}
                   for c in ranks["cases"]],
         "backend": ranks["backend"], "gloo_takes": ranks["gloo_takes"],
         "launches": ranks["launches"],
         "tp_sharded_resume_bit_identical": sharded})
    _add(launch_totals, ranks["launches"])
    for run in ("pp", "pp4"):
        res = doc[run]
        log({"phase": "parallel", "run": run, "cases": [
            {k: c.get(k) for k in ("dataset", "mode", "batch_size", "dim",
                                   "critic_iters", "microbatches",
                                   "stages", "seconds", "warm_seconds",
                                   "misses", "t", "gpipe_bubble")}
            for c in res[0]["cases"]],
             "migration": res[0].get("migration"),
             "ranks": [{"rank": i, "launches": r["launches"],
                        "bubble_share": [c["bubble_share"]
                                         for c in r["cases"]],
                        "warm_bubble_share": [c["warm_bubble_share"]
                                              for c in r["cases"]],
                        "wait_seconds": [c["wait_seconds"]
                                         for c in r["cases"]]}
                       for i, r in enumerate(res)]})
        _add(launch_totals, res[0]["launches"])
    serve = doc["serve"][0]
    log({"phase": "parallel", "run": "serve", "bucket": serve["bucket"],
         "cases": serve["cases"],
         "served_by_rank1": [c["served"] for c in doc["serve"][1]["cases"]]})
    for case in serve["cases"]:  # the int8 form of the split apply
        _add(launch_totals, case["launches"])


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log({"phase_seconds": name, "seconds": round(time.perf_counter() - t0,
                                                 3)})
    return out


# ---------------------------------------------------------------------------
# side phases: the three learning checks and the failure drills, each in a
# process of its own beside the run's untimed phases. The learning checks
# are bound by the host (the card is busy a quarter of an SSGAN iteration
# or less, the tools phase's busy_share), the drills by their CLI
# processes' start, so on a machine of several cores they overlap. They
# start after every phase that times the card; the drills' readings are
# taken beside the others.

# phase name: (phase function of this module, key of its launches or None)
SIDE_PHASES = {"failure": ("phase_failure_side", None),
               "learn": ("phase_learn", "learn"),
               "family2-learn": ("phase_family2_learn", "family2_learn"),
               "family3-learn": ("phase_family3_learn", "family3_learn"),
               "parallel": ("phase_parallel", "parallel"),
               "eval": ("phase_eval", "eval")}
SIDE_TIMEOUT = 900    # seconds from the join to the last side phase's exit
_SIDE_CODE = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.exit(chip_smoke.side_main({name!r}, {target!r}, {out!r}))
"""


def phase_failure_side(launch_totals):
    """``phase_failure`` as a side phase: its save readings on the first
    1024 rows of the train phase's synthetic set (the rows it reads)."""
    import numpy as np
    from graphical_gan_tpu_torch.data.synthetic import images_int
    phase_failure(images_int(1024, 3072, seed=0).astype(np.uint8))


def side_main(name: str, target: str, out: str) -> int:
    """A side process's body: the phase ``target`` (a function of this
    module, or ``module:function``) timed as ``name`` with a launches dict
    of its own, which is written to ``out`` as JSON. Exit code 1 on a
    failed check, or where JAX, the JAX package, PIL, matplotlib or sklearn
    was imported."""
    import importlib
    try:
        sys.path.insert(0, ROOT)
        from graphical_gan_tpu_torch.core.device import set_numerics
        set_numerics()
        mod, _, fn = target.rpartition(":")
        phase = getattr(importlib.import_module(mod) if mod
                        else sys.modules[__name__], fn)
        got = {}
        _timed(name, phase, got)
        leaked = [m for m in ("jax", "graphical_gan_tpu", "PIL",
                              "matplotlib", "sklearn") if m in sys.modules]
        if leaked:
            fail(f"{name} imported {leaked}")
        with open(out, "w") as f:
            json.dump(got, f)
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1


class SidePhases:
    """Processes of ``side_main``, one per entry of ``targets`` (phase
    name: function), each in a session of its own: ``start`` launches them
    with their output in files under ``base``, ``join`` waits for them,
    logs their output and returns each one's launches, ``stop`` ends each
    one's whole process group (the processes it started too)."""

    def __init__(self, targets, base, env=None):
        self.targets, self.base, self.env = dict(targets), base, env
        self.procs = {}

    def start(self):
        shutil.rmtree(self.base, ignore_errors=True)
        os.makedirs(self.base)
        for name, target in self.targets.items():
            out = os.path.join(self.base, f"{name}.json")
            text = os.path.join(self.base, f"{name}.out")
            code = _SIDE_CODE.format(root=ROOT, name=name, target=target,
                                     out=out)
            with open(text, "w") as f:
                self.procs[name] = (subprocess.Popen(
                    [sys.executable, "-c", code], cwd=ROOT, env=self.env,
                    stdin=subprocess.DEVNULL, stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True),
                    out, text)

    def join(self, timeout=SIDE_TIMEOUT) -> dict:
        deadline = time.perf_counter() + timeout
        got, failed = {}, []
        try:
            for name, (proc, out, text) in self.procs.items():
                try:
                    rc = proc.wait(timeout=max(
                        1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    rc = None
                with open(text) as f:
                    lines = f.read().splitlines()
                for line in lines:
                    log(line)
                if rc == 0:
                    with open(out) as f:
                        got[name] = json.load(f)
                else:
                    failed.append(f"{name} (exit code {rc}): "
                                  + "\n".join(lines[-20:]))
        finally:
            self.stop()
        if failed:
            fail("side phases failed: " + "\n".join(failed))
        return got

    def stop(self):
        import signal
        for proc, _, _ in self.procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log", default=None,
                   help="also write every logged line to this file")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    side = SidePhases({name: target for name, (target, _) in
                       SIDE_PHASES.items()},
                      os.path.join(ROOT, "graphical_gan_tpu_torch",
                                   "_build", "smoke_side"))
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
                    "loaders": {}, "eval": {}, "learn": {}, "k1": {},
                    "step_options": {}, "family2": {}, "cluster": {},
                    "family2_learn": {}, "family3": {}, "family3_serve": {},
                    "family3_learn": {}, "tools": {}, "fault4": {},
                    "phase_deconv": {}, "int8": {}, "frozen": {},
                    "quality_run": {}, "library": {}, "parallel": {},
                    "chunk": {}}
        int8_out, frozen_out = {}, {}
        _timed("build", phase_build)
        _timed("check", phase_check, errs)
        _timed("time", phase_time, timings)
        _timed("split-kernels", phase_split_kernels, errs, timings, card)
        _timed("int8-deconv", phase_int8_deconv, card, timings)
        run_dirs = _timed("serve", phase_serve, launches["serve"],
                          launches["k1"])
        missing = [k for k in SERVE_KERNELS if not launches["serve"].get(k)]
        if missing:
            fail(f"kernels never launched on the serving path: {missing}")
        _timed("dispatch", phase_dispatch, run_dirs)
        _timed("int8-export", phase_int8, launches["int8"], card, int8_out)
        data = images_int(50_000, 3072, seed=0).astype(np.uint8)
        _timed("train", phase_train, launches["train"], data,
               launches["k1"])
        missing = [k for k in TRAIN_KERNELS if not launches["train"].get(k)]
        if missing:
            fail(f"kernels never launched on the training path: {missing}")
        _timed("chunk", phase_chunk, launches["chunk"], data)
        _timed("bench-conv", phase_bench_conv, launches["bench"])
        missing = [k for k in K3_KERNELS if not launches["bench"].get(k)]
        if missing:
            fail(f"kernels never launched on the bench-conv path: {missing}")
        _timed("family1", phase_family1, launches["family1"])
        _timed("family2", phase_family2, launches["family2"])
        _timed("family3", phase_family3, launches["family3"])
        _timed("tools", phase_tools, launches["tools"], data)
        _timed("phase-deconv", phase_phase_deconv, launches["phase_deconv"])
        _timed("frozen-inception", phase_frozen_inception,
               launches["frozen"], frozen_out)
        # the side phases from here on beside the untimed phases
        side.start()
        _timed("frozen-parity", phase_frozen_parity, frozen_out)
        frozen_out.clear()
        torch.cuda.empty_cache()
        _timed("library-ops", phase_library_ops, launches["library"])
        _timed("quality-run", phase_quality_run, launches["quality_run"])
        _timed("train-parity", phase_train_parity)
        _timed("train-repeat", phase_train_repeat, data)
        _timed("family1-parity", phase_family1_parity)
        _timed("loaders", phase_loaders, launches["loaders"])
        _timed("step-options", phase_step_options, launches["step_options"])
        _timed("family2-parity", phase_family2_parity)
        _timed("cluster", phase_cluster, launches["cluster"])
        _timed("family3-parity", phase_family3_parity)
        _timed("family3-serve", phase_family3_serve,
               launches["family3_serve"])
        _timed("fault4", phase_fault4, launches["fault4"])
        got = _timed("side phases", side.join)
        for name, (_, key) in SIDE_PHASES.items():
            if key is not None:
                launches[key].update(got[name])
        for path, want in (("family2", TRAIN_KERNELS),
                           ("family2_learn", TRAIN_KERNELS),
                           ("cluster", SERVE_KERNELS),
                           ("step_options", TRAIN_KERNELS),
                           ("family3", TRAIN_KERNELS),
                           ("family3_serve", ("fused_conv2d_bias_act",)),
                           ("family3_learn", ("fused_conv2d_bias_act",)),
                           ("tools", TRAIN_KERNELS),
                           ("fault4", TRAIN_KERNELS),
                           ("phase_deconv", ("fused_conv2d_bias_act",)),
                           ("int8", INT8_KERNELS),
                           ("frozen", ("bn_stats", "bn_apply")),
                           ("quality_run", TRAIN_KERNELS),
                           ("library", ("fused_conv2d_bias_act",)),
                           ("parallel", TRAIN_KERNELS + SPLIT_KERNELS),
                           ("chunk", TRAIN_KERNELS)):
            missing = [k for k in want if not launches[path].get(k)]
            if missing:
                fail(f"kernels never launched on the {path} path: "
                     f"{missing}")
        if "jax" in sys.modules or "graphical_gan_tpu" in sys.modules:
            fail("JAX or the JAX package was imported")
        imported = [m for m in ("PIL", "matplotlib", "sklearn")
                    if m in sys.modules]
        if imported:
            fail(f"imported {imported}, which the card's machine lacks")
        log(summary(errs, timings, launches, int8_out))
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
        side.stop()
        if args.log:
            os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                        exist_ok=True)
            with open(args.log, "w") as f:
                f.write("\n".join(_LINES) + "\n")


if __name__ == "__main__":
    sys.exit(main())
