"""Dense layer (``graphical_gan_tpu/ops/linear.py``).

``W`` is stored ``[in, out]`` as in the JAX package and cast to the
activation dtype before the product, as ``linear.py:64`` does. The product
is a plain ``torch.matmul``: the JAX package computes it outside any Pallas
kernel. Inside an int8 context (``ops/quant.py``) the 2-D product runs on
Q1/Q2 instead, as JAX's ``linear.py:59-69`` intercepts it.
"""

from __future__ import annotations

from typing import Dict

import torch

from graphical_gan_tpu_torch.ops import quant


def linear(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           biases: bool = True) -> torch.Tensor:
    w = params[name + ".W"]
    b = params[name + ".b"] if biases else None
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    q = quant.intercept_linear(name, x2d, w, b)  # the bias in Q2's epilogue
    if q is not None:
        return q.reshape(*lead, w.shape[1])
    out = torch.matmul(x2d, w.to(x.dtype)).reshape(*lead, w.shape[1])
    if biases:
        out = out + b.to(out.dtype)
    return out
