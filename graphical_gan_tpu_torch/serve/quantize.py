"""PTQ calibration of the serving sampler (``graphical_gan_tpu/serve/
quantize.py``; the int8 path is ``ops/quant.py``).

Calibration runs the family's sampler eagerly on prior-distributed latents
(what the served sampler sees: serving inputs are prior draws) under
``quant.calibrating``, records each intercepted layer's input absmax and
turns the records into per-tensor activation scales. The server, the bench
tools and the quality tools build on it (``--quantize int8``).

The latents come from a ``numpy.random.Generator`` per batch, as the port's
server draws its priors (``serve/server.py: _draw_prior``), so a seed gives
other latents than the JAX package's ``jax.random`` draws. SSGAN's latent
chain is a Python loop in the port, so calibration sees its activations
with nothing like JAX's ``jax.disable_jit``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from graphical_gan_tpu_torch.ops import quant


def prior_inputs(family: str, cfg, n: int, seed: int
                 ) -> Tuple[np.ndarray, ...]:
    """``n`` rows of the sampler's prior inputs (N(0, 1) latents, uniform
    one-hot components / labels) from a numpy generator seeded ``seed``."""
    from graphical_gan_tpu_torch.serve.export import make_sampler
    from graphical_gan_tpu_torch.serve.server import _draw_prior, input_kinds

    # make_sampler reads only the model's cfg
    _, example = make_sampler(family, SimpleNamespace(cfg=cfg))
    return _draw_prior(input_kinds(family, cfg),
                       [a.shape for a in example], n, seed)


def calibrate(family: str, model, params, seed: int, n_batches: int = 4,
              batch_size: Optional[int] = None) -> Dict[str, float]:
    """Run ``n_batches`` sampler batches under ``quant.calibrating`` on the
    params' device; returns the activation scales for ``quant.quantized``.
    Batch i draws its inputs with seed ``fold_in(seed, 2i)`` and the
    sampler's own draws (SSGAN's chain eps) with ``fold_in(seed, 2i + 1)``."""
    from graphical_gan_tpu_torch.serve.export import make_sampler
    from graphical_gan_tpu_torch.serve.server import fold_in
    fn, example = make_sampler(family, model)
    n = batch_size or example[0].shape[0]
    dev = next(iter(params.values())).device
    records: Dict[str, float] = {}
    with torch.inference_mode(), quant.calibrating(records):
        for i in range(n_batches):
            inputs = prior_inputs(family, model.cfg, n,
                                  fold_in(seed, 2 * i))
            fn(params, fold_in(seed, 2 * i + 1),
               *[torch.from_numpy(a).to(dev) for a in inputs])
    if not records:
        raise RuntimeError("calibration recorded no layers — the sampler "
                           "hit no intercepted conv/deconv/linear ops")
    return quant.scales_from_records(records)


def quantized_entry(fn, scales: Dict[str, float]):
    """``fn(params, seed, *inputs)`` run under ``quant.quantized(scales)``
    with one weight cache, so the weights are quantized at the first call
    and reused after."""
    weights: Dict[str, tuple] = {}

    def call(params, seed, *inputs):
        with quant.quantized(scales, weights):
            return fn(params, seed, *inputs)
    return call
