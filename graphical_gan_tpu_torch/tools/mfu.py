"""Model-FLOP utilization of the training step on the card
(``graphical_gan_tpu/tools/mfu.py``).

Method:

1. FLOPs per iteration: :func:`flops_per_iter` counts one iteration of the
   port's step (the family's published config, on-device batch sampling,
   ``do_gen=True``, as JAX's ``_build``) under
   ``torch.utils.flop_counter.FlopCounterMode`` on the **CPU plain path**:
   every K1 there is ``F.conv2d`` (``ops/kernels/fused_conv.py:
   fused_conv2d_bias_act_plain``) and every gradient a library op the
   counter knows, so the count is the same work whatever runs it on the
   card. The hand-written kernels go through ctypes, where the counter
   cannot see them, so the count is never taken on the card. The step runs
   on fake CPU tensors (shapes only, no arithmetic), so the count costs no
   compute at any size. The counter counts convolutions and GEMMs
   (``aten.convolution``, ``convolution_backward``, ``mm``, ``addmm``,
   ``bmm``), every tap of a padded convolution included, and no
   elementwise op (PERF.md says how this differs from XLA's cost model).
   The count does not depend on the compute dtype.
2. Step time: back-to-back ``Trainer.step_fn(draw_batches(i))`` over
   resident random data on the card, bounded by ``torch.cuda.synchronize``
   (:func:`time_train`, which ``chip_smoke.py`` times its training runs
   with), best of ``--rounds`` rounds of ``--iters`` iterations.
3. MFU = flops_per_iter / sec_per_iter / peak. The peak is by card and
   compute dtype (:data:`PEAK`); ``GGAN_PEAK_FLOPS`` overrides it; an
   unknown card gives ``"mfu": null``.

No byte count per iteration is reported: the port has none that stays the
same when a kernel fuses more (ROADMAP §1).

    python -m graphical_gan_tpu_torch.tools.mfu [--family gan|gmgan|ssgan]
        [--dtype float32|bfloat16] [--rounds 5] [--iters 20] [--device cpu]

Prints one JSON line. Runs on ``cuda`` unless ``--device cpu``; without a
card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

# Dense peak FLOP/s by card and compute dtype, from NVIDIA's H100 Tensor
# Core GPU datasheet (H100 SXM column): FP32 66.9 TFLOP/s (no tensor cores:
# core/device.py: set_numerics turns TF32 off and K1 f32 runs on FMAs) and
# BF16 Tensor Core 989.4 TFLOP/s (the sheet's 1,979 is with sparsity).
PEAK = {
    "NVIDIA H100 80GB HBM3": {"float32": 66.9e12, "bfloat16": 989.4e12},
}

METRICS = {"gan": "cifar10_wali_gp_mfu",
           "gmgan": "gmgan_cifar10_local_ep_mfu",
           "ssgan": "ssgan_moving_mnist_local_ep_mfu"}


def family_model(family: str, dtype: str, **overrides):
    """(cfg, model) at the family's published config: cifar10 wali-gp,
    gmgan cifar10 local_ep, ssgan moving-MNIST local_ep."""
    if family == "gan":
        from graphical_gan_tpu_torch.core.config import gan_inference_defaults
        from graphical_gan_tpu_torch.models.gan_inference import (
            GanInferenceModel)
        cfg = gan_inference_defaults("cifar10", "wali-gp",
                                     compute_dtype=dtype, **overrides)
        return cfg, GanInferenceModel(cfg)
    if family == "gmgan":
        from graphical_gan_tpu_torch.core.config import gmgan_defaults
        from graphical_gan_tpu_torch.models.gmgan import GMGanModel
        cfg = gmgan_defaults("cifar10", "local_ep", compute_dtype=dtype,
                             **overrides)
        return cfg, GMGanModel(cfg)
    if family == "ssgan":
        from graphical_gan_tpu_torch.core.config import ssgan_defaults
        from graphical_gan_tpu_torch.models.ssgan import SSGanModel
        cfg = ssgan_defaults("moving_mnist", "local_ep", compute_dtype=dtype,
                             **overrides)
        return cfg, SSGanModel(cfg)
    raise ValueError(f"unknown family {family!r}")


def family_data(family: str, cfg, n: int = 4096, seed: int = 0):
    """Random resident data as JAX's ``_family_data`` makes it: int32 pixels
    [n, C·H·W], or for ssgan ``{'x': [n, LEN, C·H·W] in [0, 1), 'y':
    one-hot [n, n_classes]}``."""
    rng = np.random.RandomState(seed)
    if family == "ssgan":
        return {"x": rng.rand(n, cfg.seq_len,
                              cfg.output_dim).astype(np.float32),
                "y": np.eye(cfg.n_classes, dtype=np.float32)[
                    rng.randint(0, cfg.n_classes, size=n)]}
    return rng.randint(0, 256,
                       size=(n, cfg.data.output_dim)).astype(np.int32)


def make_trainer(family: str, dtype: str, outf: str, device="cuda",
                 data_rows: int = 1024, data=None, batch_sampler=None,
                 **overrides):
    """A ``Trainer`` at the family's published config over ``data_rows``
    rows of random resident data (or over ``data`` through
    ``batch_sampler``), its state initialized from seed 0 (no iteration
    run, nothing written but the settings)."""
    from graphical_gan_tpu_torch.train.trainer import Trainer
    cfg, model = family_model(family, dtype, **overrides)
    if data is None:
        data = family_data(family, cfg, n=data_rows)
    tr = Trainer(model, data, outf, seed=0, device=device,
                 checkpoint_every=0, batch_sampler=batch_sampler)
    tr.state = tr.init_state(model.init(0, tr.device))
    return tr


def flops_per_iter(dtype: str = "float32", family: str = "gan",
                   **overrides) -> float:
    """FLOPs of one iteration of the port's step (G+E update and k D
    updates), counted on fake CPU tensors under ``FlopCounterMode``.
    ``dtype`` only names the config: the count is the same for every
    compute dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
    from graphical_gan_tpu_torch.train.step import make_train_step

    cfg, model = family_model(family, dtype, **overrides)
    step, init_state = make_train_step(model)
    n = (1 + cfg.critic_iters) * cfg.batch_size
    data = to_device(family_data(family, cfg, n=n), "cpu")
    gen = torch.Generator().manual_seed(1)
    state = init_state(model.init(0, "cpu"))  # real: Adam reads its count
    with FakeTensorMode(allow_non_fake_inputs=True):
        raw = sample_batches(data, 1 + cfg.critic_iters, cfg.batch_size, gen)
        with FlopCounterMode(display=False) as counter:
            step(state, raw, True, gen)
    return float(counter.get_total_flops())


def time_train(tr, n: int) -> float:
    """Host wall ms per Trainer iteration (batches drawn and gathered on
    the device, one step), ``n`` back to back, bounded by synchronizes on a
    card."""
    cuda = tr.device.type == "cuda"
    start = tr.state.step
    if cuda:
        torch.cuda.synchronize(tr.device)
    t0 = time.perf_counter()
    for i in range(n):
        tr.step_fn(tr.state, tr.draw_batches(start + i), True, tr.generator)
    if cuda:
        torch.cuda.synchronize(tr.device)
    return (time.perf_counter() - t0) * 1e3 / n


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def peak_flops(kind: str, dtype: str):
    """FLOP/s the card peaks at for ``dtype``: ``GGAN_PEAK_FLOPS`` if set,
    else :data:`PEAK`'s entry, else None (an unknown card)."""
    env = float(os.environ.get("GGAN_PEAK_FLOPS", 0) or 0)
    return env or PEAK.get(kind, {}).get(dtype)


def mfu_record(family: str, dtype: str, flops: float, sec_per_iter: float,
               kind: str) -> dict:
    peak = peak_flops(kind, dtype)
    achieved = flops / sec_per_iter
    return {"metric": METRICS[family], "dtype": dtype,
            "flops_per_iter": flops, "flops_source": "cpu flop counter",
            "sec_per_iter": sec_per_iter,
            "achieved_tflops": achieved / 1e12, "device_kind": kind,
            "peak_tflops": peak / 1e12 if peak else None,
            "mfu": achieved / peak if peak else None}


def resident_rows(family: str) -> int:
    """Rows of resident data the timed step samples from, as JAX's
    ``measure_step_time``: 50,000 images, or 2,000 videos."""
    return 2_000 if family == "ssgan" else 50_000


def measure(family: str = "gan", dtype: str = "float32", rounds: int = 5,
            iters: int = 20, device="cuda", data_rows=None,
            **overrides) -> dict:
    """The MFU record of ``family``'s step in ``dtype`` on ``device``."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    flops = flops_per_iter(dtype, family, **overrides)
    with tempfile.TemporaryDirectory() as outf:
        tr = make_trainer(family, dtype, outf, dev,
                          data_rows=data_rows or resident_rows(family),
                          **overrides)
        time_train(tr, 2)  # warm: kernel builds, cuDNN plans, allocator
        ms = min(time_train(tr, iters) for _ in range(rounds))
    return mfu_record(family, dtype, flops, ms / 1e3, device_kind(dev))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--family", default="gan", choices=sorted(METRICS))
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iters", type=int, default=20,
                   help="back-to-back iterations per timed round")
    p.add_argument("--dim", type=int, default=None,
                   help="override the model width (smoke/testing)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--data-rows", type=int, default=None,
                   help="resident rows (default 50,000 images, 2,000 "
                        "videos)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("dim", args.dim),
                                   ("batch_size", args.batch_size))
                 if v is not None}
    rec = measure(args.family, args.dtype, args.rounds, args.iters,
                  args.device, args.data_rows, **overrides)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
