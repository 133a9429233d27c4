"""Checkpoints in the JAX package's npz format (``graphical_gan_tpu/train/
checkpoint.py``), numpy only.

A checkpoint is one ``.npz`` of keypath-flattened arrays plus a
``__header__`` JSON string ``{"extra": {...}, "keys": [...]}``. Both
trainers save their whole ``TrainState`` under the JAX keypaths
(``checkpoint.py:28-43``): ``n:params|k:<name>``, ``n:gen_opt|k:m|k:<name>``,
``n:gen_opt|k:t``, ``n:gen_opt|k:master|k:<name>``, ``n:disc_opt|...`` and
``n:step``; so a JAX run directory resumes in the port and a port
checkpoint restores in JAX. This module reads any such file, lists and
picks the checkpoints of a run directory, writes a params-only checkpoint
(so a run directory can be made without a trainer), a plain dict (the
metric classifier's parameters, keys ``k:<name>``) or a whole state, and
carries JAX parameters or a whole JAX state into the port
(:func:`params_from_jax`, :func:`state_from_jax`). The orbax and
pipeline-parallel layouts come in a later slice.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple, Union

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
            "(orbax comes in a later slice)")
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


def dict_of(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ``{name: array}`` of a checkpoint of a plain dict, which the JAX
    ``checkpoint.save`` writes under keys ``k:<name>`` (e.g. a
    ``MetricClassifier``'s parameters)."""
    return {k[len("k:"):]: v for k, v in flat.items()
            if k.startswith("k:") and SEP not in k}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def save_params(path: str, params: Dict[str, torch.Tensor],
                extra: Optional[Dict] = None) -> str:
    """Atomically write a params-only checkpoint in the npz format."""
    return _save_flat(path, {PARAMS_PREFIX + name: _to_numpy(t)
                             for name, t in params.items()}, extra)


def save_dict(path: str, params: Dict[str, torch.Tensor],
              extra: Optional[Dict] = None) -> str:
    """Atomically write a plain ``{name: tensor}`` dict as the JAX
    ``checkpoint.save`` writes one (keys ``k:<name>``): its
    ``checkpoint.restore`` reads it into the same dict structure."""
    return _save_flat(path, {"k:" + name: _to_numpy(t)
                             for name, t in params.items()}, extra)


def _save_flat(path: str, flat: Dict[str, np.ndarray],
               extra: Optional[Dict]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
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


# -- the whole TrainState ------------------------------------------------------

_FIELDS = ("params", "gen_opt", "disc_opt", "step")


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{SEP}k:{k}", out)
    else:
        out[prefix] = tree


def state_leaves(state) -> Dict[str, Any]:
    """``{keypath: leaf}`` of a TrainState (``step`` as an int32 scalar)."""
    out: Dict[str, Any] = {}
    for field in _FIELDS:
        value = getattr(state, field)
        if field == "step":
            value = torch.tensor(int(value), dtype=torch.int32)
        _flatten(value, f"n:{field}", out)
    return out


def _unflatten(leaves: Dict[str, Any]):
    from graphical_gan_tpu_torch.train.step import TrainState
    top: Dict[str, Any] = {"disc_opt": {}}
    for key, leaf in leaves.items():
        parts = key.split(SEP)
        field = parts[0][len("n:"):]
        if len(parts) == 1:
            top[field] = leaf
            continue
        node = top.setdefault(field, {})
        for p in parts[1:-1]:
            node = node.setdefault(p[len("k:"):], {})
        node[parts[-1][len("k:"):]] = leaf
    top["step"] = int(top["step"])
    return TrainState(**top)


def save_state(path: str, state, extra: Optional[Dict] = None) -> str:
    """Atomically write a whole TrainState in the JAX npz format."""
    return _save_flat(path, {k: _to_numpy(t)
                             for k, t in state_leaves(state).items()}, extra)


def restore_state(path: str, like) -> Tuple[Any, Dict]:
    """(TrainState, extra) from an npz checkpoint of either trainer, into
    the structure of ``like``: every leaf of ``like`` must be there with its
    shape; each comes back on the device and in the dtype of ``like``'s."""
    flat, extra = load_raw(path)
    leaves = {}
    for key, ref in state_leaves(like).items():
        if key not in flat:
            raise KeyError(f"checkpoint {path!r} missing leaf {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                             f"{arr.shape} vs state {tuple(ref.shape)}")
        leaves[key] = _to_tensor(arr, ref.device).to(ref.dtype)
    return _unflatten(leaves), extra


def state_from_jax(jax_state, device: Union[str, torch.device] = "cuda"):
    """A JAX ``TrainState`` whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's TrainState: params,
    moments and masters on ``device``, Adam's ``t`` on the CPU (where the
    port's optimizer keeps it), ``step`` an int."""
    from graphical_gan_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    leaves: Dict[str, Any] = {}
    for field in _FIELDS:
        value = getattr(jax_state, field)
        if isinstance(value, tuple) and not value:  # JAX's empty disc_opt
            value = {}
        _flatten(value, f"n:{field}", leaves)
    for key, arr in leaves.items():
        on = "cpu" if key.endswith(SEP + "k:t") or key == "n:step" else dev
        leaves[key] = _to_tensor(np.asarray(arr), on)
    return _unflatten(leaves)
