"""Dense layer (``graphical_gan_tpu/ops/linear.py``).

``W`` is stored ``[in, out]`` as in the JAX package and cast to the
activation dtype before the product, as ``linear.py:64`` does. The product
is a plain ``torch.matmul``: the JAX package computes it outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Dict

import torch


def linear(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           biases: bool = True) -> torch.Tensor:
    w = params[name + ".W"]
    lead = x.shape[:-1]
    out = torch.matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    out = out.reshape(*lead, w.shape[1])
    if biases:
        out = out + params[name + ".b"].to(out.dtype)
    return out
