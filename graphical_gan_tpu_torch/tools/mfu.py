"""Model-FLOP utilization of the training step on the card, with its
roofline companion (``graphical_gan_tpu/tools/mfu.py``).

Method:

1. Cost per iteration: :func:`cost_per_iter` counts one iteration of the
   port's step (the family's published config, on-device batch sampling,
   ``do_gen=True``, as JAX's ``_build``) in one pass on fake CPU tensors
   (shapes only, no arithmetic, so no compute at any size) over the **CPU
   plain path**: every K1 there is ``F.conv2d`` (``ops/kernels/
   fused_conv.py: fused_conv2d_bias_act_plain``) and every gradient a
   library op, so the count is the same work whatever runs it on the card.
   The hand-written kernels go through ctypes, where no dispatch mode sees
   them, so the count is never taken on the card. It returns JAX's keys:

   - ``"flops"``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
     the convolutions and GEMMs (``aten.convolution``,
     ``convolution_backward``, ``mm``, ``addmm``, ``bmm``, and those the
     penalty's double backward runs), every tap of a padded convolution
     included, no elementwise op (PERF.md says how this differs from XLA's
     cost model). It does not depend on the compute dtype.
   - ``"bytes accessed"``: the bytes the iteration must move, in two terms.
     (a) The **contractions**, the ops the FLOP counter counts: each
     operand the op's results need is read once and each result it
     actually produces is written once, at the tensor's own element size;
     a permuted, strided or broadcast view counts the elements it refers
     to, once. A ``convolution_backward`` produces only the gradients its
     ``output_mask`` asks for (``input_grads_only`` asks for dx alone) and
     reads the input only for dw, the filter only for dx. The count is of
     the function, not of the plain version (:class:`ByteCounter`): a
     tensor the plain path widened from a narrower one counts at the
     narrower size (the plain K1 sums bf16 products in f32 where the
     card's kernel reads and writes bf16), a convolution's input that the
     plain path padded for SAME counts its unpadded elements (K1 and XLA
     pad inside the window), and so does the dx of it; a transposed
     convolution's result counts the part SAME keeps. (b) The
     **optimizer**: per update every parameter, f32 master copy and
     moment (Adam's m and v, RMSProp's ms) is read once and written once
     and every gradient is read once, each at its own dtype
     (``optim/optimizers.py``); one iteration is one G+E update and k D
     updates (:func:`optimizer_bytes`).
     Elementwise, normalization, reduction, gather and layout ops are left
     out, as the FLOP counter leaves them out: a fused kernel can remove
     their traffic. So the count is the same whatever implements each op,
     and a lower bound for any implementation that writes each
     contraction's result to memory once. Only a kernel that fused two
     contractions could move less, and no model path has one.

2. Step time: back-to-back iterations of the Trainer's dispatch over
   resident random data on the card (on a card with no mesh, the step
   graph's replays), bounded by ``torch.cuda.synchronize``
   (:func:`time_train`, which ``chip_smoke.py`` times its training runs
   with), best of ``--rounds`` rounds of ``--iters`` iterations after
   three that warm and capture.
3. MFU = flops / sec_per_iter / peak, by card and compute dtype
   (:data:`PEAK`; ``GGAN_PEAK_FLOPS`` overrides it). ``achieved_gbps`` =
   bytes / sec_per_iter / 1e9 and ``hbm_bw_util`` = bytes / sec_per_iter
   over the card's HBM rate (:data:`PEAK_BW`; ``GGAN_PEAK_BW`` overrides
   it). Low MFU beside high ``hbm_bw_util`` says the step is
   bandwidth-bound, not badly scheduled. An unknown card (or the CPU)
   gives ``null`` for either.

    python -m graphical_gan_tpu_torch.tools.mfu [--family gan|gmgan|ssgan]
        [--dtype float32|bfloat16] [--rounds 5] [--iters 20] [--device cpu]

Prints one JSON line. Runs on ``cuda`` unless ``--device cpu``; without a
card it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

H100 = "NVIDIA H100 80GB HBM3"
# The card's peaks, the one table the port's tools and chip_smoke.py read.
# Dense FLOP/s (int8: operations/s) by compute dtype, from NVIDIA's H100
# Tensor Core GPU datasheet (H100 SXM column): FP32 66.9 TFLOP/s (no tensor
# cores: core/device.py: set_numerics turns TF32 off and K1 f32 runs on
# FMAs), BF16 Tensor Core 989.4 TFLOP/s and INT8 Tensor Core 1,979 TOPS
# (the sheet's 1,979 TFLOP/s and 3,958 TOPS are with sparsity).
PEAK = {
    H100: {"float32": 66.9e12, "bfloat16": 989.4e12, "int8": 1979e12},
}
# HBM bytes/s by card: the same datasheet's 3.35 TB/s.
PEAK_BW = {H100: 3.35e12}

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


# the ops FlopCounterMode counts that a model path runs
CONTRACTIONS = ("aten.convolution", "aten._convolution",
                "aten.convolution_backward", "aten.mm", "aten.addmm",
                "aten.bmm", "aten.baddbmm")
# ops whose result holds its input's data, cast or copied (with the view
# ops), or padded with zeros (a crop's backward pads): the result carries
# the input's extent
_COPIES = ("aten._to_copy", "aten.clone", "aten._unsafe_view")
_PADS = ("aten.constant_pad_nd", "aten.slice_backward")


def _elements(t: torch.Tensor) -> int:
    """Elements a view refers to, each once (a broadcast axis adds none)."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st)


class ByteCounter(TorchDispatchMode):
    """The contraction term of the byte count (module docstring, (a)):
    ``total`` bytes, ``ops`` one ``[op, bytes]`` per contraction.

    A tensor the plain path made from another by a cast, a copy or a view
    of all its elements carries its source's extent (elements, element
    size), at the narrower size of the two: a widened copy counts at its
    source's dtype. A zero-padded tensor (``F.pad``, a crop's backward)
    carries its source's elements too, for a convolution only: the plain
    path pads a SAME convolution's input where the card's K1 and XLA take
    the pads inside the window, while a GEMM reads the zeros it is given.
    A ``convolution_backward``'s dx counts the extent of the input it is
    the gradient of, and a transposed convolution's result the part that
    a slice of it keeps (``ops/conv.py: conv_transpose`` computes the whole
    (H-1)·s + k output and keeps SAME's H·s)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops = []
        # tensor -> (elements, element size, padded)
        self._extent = WeakIdKeyDictionary()
        # view of a transposed convolution's result -> [op, elements, size]
        self._kept = WeakIdKeyDictionary()

    def _of(self, t: torch.Tensor, conv: bool = False):
        """(elements, element size) of ``t`` as a contraction reads it."""
        e, size, padded = self._extent.get(
            t, (_elements(t), t.element_size(), False))
        return (_elements(t) if padded and not conv else e), size

    def _count(self, name, read, written, conv: bool) -> int:
        """Count one contraction, ``written`` as (tensor, elements); returns
        the element size it ran at (its widest operand's)."""
        size = max(self._of(t, conv)[1] for t in read)
        nbytes = sum(math.prod(self._of(t, conv)) for t in read) + sum(
            e * min(size, t.element_size()) for t, e in written)
        self.total += nbytes
        self.ops.append([name, nbytes])
        return size

    def _carry(self, name, src, outs) -> None:
        e, size, padded = self._extent.get(
            src, (_elements(src), src.element_size(), False))
        pad = name in _PADS
        for t in outs:
            whole = pad or t.numel() == src.numel()
            carried = (e if whole else _elements(t),
                       min(size, t.element_size()), whole and (pad or padded))
            if carried != (_elements(t), t.element_size(), False):
                self._extent[t] = carried

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name == "aten.convolution_backward":
            go, x, w, mask = args[0], args[1], args[2], args[10]
            read = [t for t, need in ((go, any(mask)), (w, mask[0]),
                                      (x, mask[1])) if need]
            dx, dw, db = out
            written = [(dx, self._of(x, True)[0])] if dx is not None else []
            written += [(t, _elements(t)) for t in (dw, db) if t is not None]
            self._count(name, read, written, True)
        elif name in CONTRACTIONS:
            conv = "conv" in name
            read = [a for a in args if isinstance(a, torch.Tensor)]
            size = self._count(name, read, [(out, _elements(out))], conv)
            if name == "aten.convolution" and args[6]:
                self._kept[out] = [len(self.ops) - 1, _elements(out),
                                   min(size, out.element_size())]
        elif func.is_view or name in _COPIES or name in _PADS:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self._carry(name, args[0], outs)
            if func.is_view and len(outs) == 1 and args[0] in self._kept:
                i, kept, size = self._kept[args[0]]
                if name == "aten.slice":  # the crop: count what it keeps
                    cut = (kept - _elements(out)) * size
                    self.ops[i][1] -= cut
                    self.total -= cut
                    kept = _elements(out)
                self._kept[out] = [i, kept, size]
        return out


def update_bytes(opt_state: dict, params: dict) -> int:
    """Bytes one optimizer update of ``params`` moves: each parameter and
    each per-parameter state tensor (Adam's m and v, RMSProp's ms, the f32
    master) read once and written once, each gradient (in its parameter's
    dtype) read once."""
    total = 0
    for n, p in params.items():
        total += 3 * p.numel() * p.element_size()
        for leaf in opt_state.values():
            if isinstance(leaf, dict):
                total += 2 * leaf[n].numel() * leaf[n].element_size()
    return total


def optimizer_bytes(model, state) -> int:
    """The optimizer term of one iteration from the ``TrainState``: one
    G+E update and, where the mode has a D, k D updates."""
    from graphical_gan_tpu_torch.core.registry import partition
    total = update_bytes(state.gen_opt,
                         partition(state.params, model.GEN_PLAYER)[0])
    if state.disc_opt:
        total += model.cfg.critic_iters * update_bytes(
            state.disc_opt, partition(state.params, model.DISC_PLAYER)[0])
    return total


def cost_per_iter(dtype: str = "float32", family: str = "gan",
                  **overrides) -> dict:
    """``{"flops", "bytes accessed"}`` of one iteration of the port's step
    (G+E update and k D updates), JAX's keys (module docstring, 1): one
    pass on fake CPU tensors under ``FlopCounterMode`` and
    :class:`ByteCounter`, plus :func:`optimizer_bytes` from the state."""
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
    optimizer = optimizer_bytes(model, state)
    with FakeTensorMode(allow_non_fake_inputs=True):
        raw = sample_batches(data, 1 + cfg.critic_iters, cfg.batch_size, gen)
        with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
            step(state, raw, True, gen)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.total + optimizer)}


def flops_per_iter(dtype: str = "float32", family: str = "gan",
                   **overrides) -> float:
    """FLOPs of one iteration: ``cost_per_iter(...)["flops"]``. ``dtype``
    only names the config: the count is the same for every compute
    dtype."""
    return cost_per_iter(dtype, family, **overrides)["flops"]


def time_train(tr, n: int) -> float:
    """Host wall ms per Trainer iteration (batches drawn and gathered on
    the device, one step), ``n`` back to back as the trainer runs them (its
    dispatch: the step graph's replays where ``Trainer.eager_reason``
    allows them), bounded by synchronizes on a card."""
    cuda = tr.device.type == "cuda"
    start = tr.state.step
    if cuda:
        torch.cuda.synchronize(tr.device)
    t0 = time.perf_counter()
    tr.dispatch(start, n, [])
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


def peak_bw(kind: str):
    """HBM bytes/s of the card: ``GGAN_PEAK_BW`` if set, else
    :data:`PEAK_BW`'s entry, else None (an unknown card)."""
    env = float(os.environ.get("GGAN_PEAK_BW", 0) or 0)
    return env or PEAK_BW.get(kind)


def card_peaks(kind: str):
    """(:data:`PEAK`'s row, :data:`PEAK_BW`'s rate) of the card named
    ``kind``, for a roofline bound; raises KeyError for a card not in the
    tables."""
    if kind not in PEAK or kind not in PEAK_BW:
        raise KeyError(f"no peaks for card {kind!r} in tools/mfu.py "
                       f"(PEAK, PEAK_BW)")
    return PEAK[kind], PEAK_BW[kind]


def mfu_record(family: str, dtype: str, flops: float, sec_per_iter: float,
               kind: str, nbytes: float) -> dict:
    peak, bw = peak_flops(kind, dtype), peak_bw(kind)
    achieved = flops / sec_per_iter
    rate = nbytes / sec_per_iter
    return {"metric": METRICS[family], "dtype": dtype,
            "flops_per_iter": flops, "flops_source": "cpu flop counter",
            "sec_per_iter": sec_per_iter,
            "achieved_tflops": achieved / 1e12, "device_kind": kind,
            "peak_tflops": peak / 1e12 if peak else None,
            "mfu": achieved / peak if peak else None,
            "bytes_per_iter": nbytes, "bytes_source": "cpu byte counter",
            "achieved_gbps": rate / 1e9,
            "hbm_bw_util": rate / bw if bw else None}


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
    cost = cost_per_iter(dtype, family, **overrides)
    with tempfile.TemporaryDirectory() as outf:
        tr = make_trainer(family, dtype, outf, dev,
                          data_rows=data_rows or resident_rows(family),
                          **overrides)
        # warm: kernel builds, cuDNN plans, allocator, the graph's capture
        time_train(tr, 3)
        ms = min(time_train(tr, iters) for _ in range(rounds))
    return mfu_record(family, dtype, cost["flops"], ms / 1e3,
                      device_kind(dev), cost["bytes accessed"])


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
