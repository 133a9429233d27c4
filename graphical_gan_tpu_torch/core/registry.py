"""Player partition of a ``{name: tensor}`` params dict by name
(``graphical_gan_tpu/core/registry.py:198-219``): the reference's
``params_with_name`` matches a substring, and the scripts always pass a
prefix word ('Generator', 'Extractor', 'Discriminator')."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


def partition(params: Params, names: Sequence[str]) -> Tuple[Params, Params]:
    """Split params into (matching any of ``names``, rest)."""
    hit = {n: p for n, p in params.items() if any(s in n for s in names)}
    rest = {n: p for n, p in params.items() if n not in hit}
    return hit, rest


def merge(*parts: Params) -> Params:
    out: Params = {}
    for p in parts:
        out.update(p)
    return out
