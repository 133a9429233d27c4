"""Shared model utilities (``graphical_gan_tpu/models/common.py``): input
normalization, the BN + activation dispatch, and :class:`Draws`, the source
of a loss's random numbers."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from graphical_gan_tpu_torch.parallel import context
from graphical_gan_tpu_torch.ops.activations import activation
from graphical_gan_tpu_torch.ops.norm import batchnorm_act

_log = threading.local()

#: the draws of family 1's aggregated-posterior objectives, over
#: ``z_samples`` rows, not the batch's (``models/gan_inference.py``)
NOT_ROW_DRAWS = frozenset({"mix_idx", "mix_eps", "z_prior"})


@contextmanager
def recording_draws(log: List[dict]):
    """Append to ``log`` every draw a :class:`Draws` makes from its
    generator while the block runs (not the given ones), in order: its
    ``kind`` (normal, uniform, randint), ``name``, ``shape``, ``dtype`` and
    ``high``. ``serve/export.py`` learns from it which draws an entry makes,
    to draw them outside the exported program."""
    _log.draws = log
    try:
        yield log
    finally:
        _log.draws = None


def _logged(kind: str, name: str, shape, dtype: torch.dtype, high=None):
    log = getattr(_log, "draws", None)
    if log is not None:
        log.append({"kind": kind, "name": name, "shape": list(shape),
                    "dtype": str(dtype).replace("torch.", ""),
                    "high": high})


class Draws:
    """The random numbers of one model call, by name.

    A name the caller passed in (``given``; the parity tests pass the JAX
    package's draws) is used as it is, cast to the asked dtype and moved to
    the asked device; any other is drawn from ``generator`` (the global
    stream when it is None). The JAX package draws each from its own key of
    the registry's stream, so the names stand where the keys stood there.

    Where the batch's rows are sharded over ranks (``parallel/context.py``),
    a draw over the rows is made at the global batch, from the seed every
    rank shares, and the rank keeps its own rows; a given draw may come at
    the global batch too. The draws over no batch rows
    (``NOT_ROW_DRAWS``) are made whole on every rank."""

    def __init__(self, given: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        self.given = dict(given or {})
        self.generator = generator

    @staticmethod
    def _rows(name: str, shape):
        """(data group, the global batch's shape) where the batch's rows
        are sharded (``parallel/context.py``) and ``name`` is a draw over
        them, else (None, shape)."""
        group = context.rows_group()
        if group is None or name in NOT_ROW_DRAWS or not shape:
            return None, tuple(shape)
        return group, (shape[0] * group.size,) + tuple(shape[1:])

    @staticmethod
    def _own(t: torch.Tensor, group, n: int) -> torch.Tensor:
        return t if group is None else t[group.index * n:
                                         (group.index + 1) * n]

    def _given(self, name, shape, dtype, device):
        t = self.given.get(name)
        if t is None:
            return None
        group, full = self._rows(name, shape)
        if group is not None and tuple(t.shape) == full:
            t = self._own(t, group, shape[0])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: given {tuple(t.shape)}, the "
                             f"model needs {tuple(shape)}")
        return t.to(device=device, dtype=dtype)

    def normal(self, name: str, shape: Sequence[int], dtype: torch.dtype,
               device) -> torch.Tensor:
        t = self._given(name, shape, dtype, device)
        if t is None:
            group, full = self._rows(name, shape)
            _logged("normal", name, full, dtype)
            t = self._own(torch.randn(full, generator=self.generator,
                                      device=device, dtype=dtype),
                          group, shape[0] if shape else 0)
        return t

    def uniform(self, name: str, shape: Sequence[int], device
                ) -> torch.Tensor:
        """U[0, 1) in f32."""
        t = self._given(name, shape, torch.float32, device)
        if t is None:
            group, full = self._rows(name, shape)
            _logged("uniform", name, full, torch.float32)
            t = self._own(torch.rand(full, generator=self.generator,
                                     device=device),
                          group, shape[0] if shape else 0)
        return t

    def randint(self, name: str, high: int, shape: Sequence[int], device
                ) -> torch.Tensor:
        """Integers in [0, high), int64."""
        t = self._given(name, shape, torch.int64, device)
        if t is None:
            group, full = self._rows(name, shape)
            _logged("randint", name, full, torch.int64, high)
            t = self._own(torch.randint(0, high, full,
                                        generator=self.generator,
                                        device=device),
                          group, shape[0] if shape else 0)
        return t


def normalize_input(cfg, raw: torch.Tensor, compute_dtype: torch.dtype,
                    draws: Optional[Draws] = None) -> torch.Tensor:
    """Per-dataset raw -> network-input mapping (``config.DataSpec``):
    mnist [0,1] passthrough; cifar/svhn int -> [-1,1] via /255; celebA
    int -> [-1,1] via /256 plus U(0, 1/128) dequantization noise (the
    uniform draw ``dequant``, [B, D] f32); video float [0,1] -> [-1,1];
    chairs int /256. The result is cast to the compute dtype, as
    ``models/common.py:34``."""
    norm = cfg.data.normalization
    x = raw.float()
    if norm == "unit":
        pass
    elif norm == "int_pm1":
        x = 2.0 * (x / 255.0 - 0.5)
    elif norm == "dequant":
        x = 2.0 * (x / 256.0 - 0.5)
        u = (draws or Draws()).uniform("dequant", x.shape, x.device)
        x = x + u * (1.0 / 128.0)
    elif norm == "unit_pm1":
        x = 2.0 * (x - 0.5)
    elif norm == "int256_pm1":
        x = 2.0 * (x / 256.0 - 0.5)
    else:
        raise ValueError(norm)
    return x.to(compute_dtype)


def bn_act(flag: bool, params: Dict[str, torch.Tensor], name: str,
           x: torch.Tensor, act: str, axes=None) -> torch.Tensor:
    """act(batchnorm(x)) when BN is on, else the plain activation."""
    if flag:
        return batchnorm_act(params, name, x, act, axes=axes)
    return activation(act)(x)
