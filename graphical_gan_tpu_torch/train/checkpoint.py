"""Checkpoints in the JAX package's npz format (``graphical_gan_tpu/train/
checkpoint.py``), numpy only.

A checkpoint is one ``.npz`` of keypath-flattened arrays plus a
``__header__`` JSON string ``{"extra": {...}, "keys": [...]}``. The JAX
trainer saves its whole ``TrainState``; the parameters are the keys
``n:params|k:<name>``. This module reads any such file, lists and picks the
checkpoints of a run directory, writes a params-only checkpoint in the same
format (so a run directory can be made without JAX), and carries JAX
parameters into the port (:func:`params_from_jax`). Optimizer state and the
orbax and pipeline-parallel layouts come with the training slice.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

SEP = "|"
PARAMS_PREFIX = "n:params" + SEP + "k:"


def is_orbax(path: str) -> bool:
    return path.rstrip("/").endswith(".orbax")


def load_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """The flat ``{keypath: array}`` dict of an npz checkpoint and its
    ``extra`` metadata."""
    if is_orbax(path):
        raise NotImplementedError(
            f"{path!r} is an orbax checkpoint; the port reads the npz format "
            "(orbax comes with the training slice)")
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["__header__"]))
        flat = {k: data[k] for k in data.files if k != "__header__"}
    return flat, header["extra"]


def params_of(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ``{name: array}`` parameters inside a flat checkpoint dict."""
    return {k[len(PARAMS_PREFIX):]: v for k, v in flat.items()
            if k.startswith(PARAMS_PREFIX)}


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch can't view
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameters (``{name: ndarray}``, e.g. ``{k: np.asarray(v)}`` of a
    JAX ``init`` or the params of a JAX checkpoint) as the port's tensors on
    ``device``. Names, shapes and layouts carry over unchanged: conv HWIO,
    deconv ``(k, k, out, in)``, linear ``[in, out]``."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    return {name: _to_tensor(np.asarray(arr), dev)
            for name, arr in np_params.items()}


def save_params(path: str, params: Dict[str, torch.Tensor],
                extra: Optional[Dict] = None) -> str:
    """Atomically write a params-only checkpoint in the npz format."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {PARAMS_PREFIX + name: t.detach().float().cpu().numpy()
            if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
            for name, t in params.items()}
    header = {"extra": extra or {}, "keys": sorted(flat)}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __header__=json.dumps(header), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def list_checkpoints(dirpath: str, prefix: str = "ckpt_"):
    """Sorted [(step, path)] of well-formed ``<prefix><step>.npz`` files and
    ``<prefix><step>.orbax`` directories (the latter only with their
    ``.extra.json`` sidecar, which marks a finished save)."""
    if not os.path.isdir(dirpath):
        return []
    out = []
    for fn in os.listdir(dirpath):
        if not fn.startswith(prefix):
            continue
        for ext in (".npz", ".orbax"):
            if fn.endswith(ext):
                try:
                    step = int(fn[len(prefix):-len(ext)])
                except ValueError:
                    break
                path = os.path.join(dirpath, fn)
                if ext == ".orbax" and not os.path.exists(
                        path + ".extra.json"):
                    break
                out.append((step, path))
                break
    return sorted(out)


def latest(dirpath: str, prefix: str = "ckpt_") -> Optional[str]:
    """Path of the highest-step checkpoint in ``dirpath`` (or None)."""
    ckpts = list_checkpoints(dirpath, prefix)
    return ckpts[-1][1] if ckpts else None
