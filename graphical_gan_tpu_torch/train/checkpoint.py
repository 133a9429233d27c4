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
(:func:`params_from_jax`, :func:`state_from_jax`). :class:`AsyncWriter`
writes a checkpoint on an ordered worker thread from a snapshot the caller
took on the card, and :func:`remove` deletes one (JAX ``train/
checkpoint.py:121-160, 192-210``). A parallel run's state (TP's and EP's
parameters held in slices) is gathered whole on every rank and written
by rank 0 in this same layout, and a resume reads the npz and cuts each
rank's slices again (``parallel/mesh.py: make_sharded_step``'s
``gather_state`` and ``place``; ``train/trainer.py``), so a JAX npz
still loads into a sharded run. A pipeline run's state (``parallel/
pipeline.py``, a dict ``{packed, m, v, t, step}``) goes under JAX's keys
of a dict, ``k:packed`` and so on. :func:`save_state` and
:func:`restore_state` take either state and dispatch on the path: a
``ckpt_<step>.orbax`` directory is the sharded backend
(``train/checkpoint_orbax.py``), anything else the npz file.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

SEP = "|"
PARAMS_PREFIX = "n:params" + SEP + "k:"


def is_orbax(path: str) -> bool:
    return path.rstrip("/").endswith(".orbax")


def load_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """The flat ``{keypath: array}`` dict of an npz checkpoint and its
    ``extra`` metadata (npz only: a sharded directory is read by
    structure, :func:`restore`, or its keys by :func:`leaf_shapes`)."""
    if is_orbax(path):
        raise ValueError(
            f"{path!r} is an orbax (sharded) checkpoint; raw keypath "
            "inspection reads the npz format: restore it by structure, or "
            "list its leaves with leaf_shapes")
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
    deconv ``(k, k, out, in)``, conv1d WIO, linear ``[in, out]``,
    weight normalization's ``.g`` ``[out]``, ``cond_batchnorm``'s
    per-label ``.offset`` / ``.scale`` ``[n_labels, C]``, minibatch
    discrimination's 3-D ``.W`` ``[in, kernels, dim]``, the ladder's
    ``.a1``-``.c4``: every name the port's ops read is the JAX op's."""
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


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
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


class AsyncWriter:
    """Checkpoint writes on one ordered worker thread.

    ``submit`` takes the ``{keypath: leaf}`` of a snapshot the caller made
    on the card (a clone per leaf, on its current stream) and the CUDA
    event recorded after it; the worker waits on that event, copies the
    leaves to the host on a stream of its own and writes the npz
    atomically (a temp file, then ``os.replace``), then runs ``after``
    (the trainer's checkpoint collection). The training loop pays only for
    the clones. Depth one: a new submit joins the previous write first, so
    at most one snapshot is alive and writes finish in submission order. A
    worker's exception re-raises on the next ``submit`` or ``join``, once.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, path: str, leaves: Dict[str, Any],
               extra: Optional[Dict], ready=None, after=None) -> None:
        self.join()

        def work():
            try:
                if ready is not None:
                    ready.synchronize()
                _save_flat(path, _host_leaves(leaves), extra)
                if after is not None:
                    after()
            except BaseException as e:  # noqa: BLE001 — raised on join
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _host_leaves(leaves: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The leaves as numpy arrays; the card's are copied on a side stream,
    so the copies do not queue behind the training stream's work."""
    cuda = [t for t in leaves.values()
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    if not cuda:
        return {k: _to_numpy(t) for k, t in leaves.items()}
    with torch.cuda.stream(torch.cuda.Stream(cuda[0].device)):
        return {k: _to_numpy(t) for k, t in leaves.items()}


def snapshot(state) -> Tuple[Dict[str, Any], Any]:
    """``({keypath: clone}, event)``: one clone per leaf of ``state`` on the
    current stream, and a CUDA event recorded after them (None where no
    leaf is on the card), for :class:`AsyncWriter`."""
    leaves = {k: t.detach().clone() for k, t in state_leaves(state).items()}
    event = None
    if any(t.device.type == "cuda" for t in leaves.values()):
        event = torch.cuda.Event()
        event.record()
    return leaves, event


def remove(path: str) -> None:
    """Delete one checkpoint: an npz file, or an orbax directory with its
    ``.extra.json`` sidecar. One that is already gone is no error."""
    if is_orbax(path):
        shutil.rmtree(path, ignore_errors=True)
        path = path.rstrip("/") + ".extra.json"
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


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
    """``{keypath: leaf}`` of a TrainState, or of a dict state (a
    pipeline run's, ``k:<field>``); ``step`` as an int32 scalar."""
    out: Dict[str, Any] = {}
    if isinstance(state, dict):
        for field, value in state.items():
            if field == "step":
                value = torch.tensor(int(value), dtype=torch.int32)
            _flatten(value, f"k:{field}", out)
        return out
    for field in _FIELDS:
        value = getattr(state, field)
        if field == "step":
            value = torch.tensor(int(value), dtype=torch.int32)
        _flatten(value, f"n:{field}", out)
    return out


def unflatten_like(leaves: Dict[str, Any], like):
    """The state of ``like``'s kind from its ``{keypath: leaf}``."""
    if not isinstance(like, dict):
        return _unflatten(leaves)
    out: Dict[str, Any] = {}
    for key, leaf in leaves.items():
        parts = [p[len("k:"):] for p in key.split(SEP)]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    if "step" in out:
        out["step"] = int(out["step"])
    return out


def leaf_shapes(path: str) -> Dict[str, Tuple[int, ...]]:
    """keypath -> shape of every leaf of a checkpoint, npz or sharded."""
    if is_orbax(path):
        from graphical_gan_tpu_torch.train import checkpoint_orbax
        return checkpoint_orbax.leaf_shapes(path)
    with np.load(path, allow_pickle=False) as data:
        return {k: tuple(data[k].shape) for k in data.files
                if k != "__header__"}


def _unflatten(leaves: Dict[str, Any]):
    from graphical_gan_tpu_torch.train.step import TrainState
    top: Dict[str, Any] = {"gen_opt": {}, "disc_opt": {}}
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
    """Atomically write a whole TrainState (or a pipeline state) in the
    JAX npz format, or through the sharded backend for a ``.orbax`` path
    (in a process group every rank calls it)."""
    if is_orbax(path):
        from graphical_gan_tpu_torch.train import checkpoint_orbax
        return checkpoint_orbax.save(path, state, extra)
    return _save_flat(path, {k: _to_numpy(t)
                             for k, t in state_leaves(state).items()}, extra)


def restore_state(path: str, like) -> Tuple[Any, Dict]:
    """(state, extra) from a checkpoint of either trainer, into the
    structure of ``like`` (a TrainState or a pipeline state): every leaf
    of ``like`` must be there with its shape; each comes back on the
    device and in the dtype of ``like``'s. A ``.orbax`` directory reads
    through ``train/checkpoint_orbax.py``."""
    if is_orbax(path):
        from graphical_gan_tpu_torch.train import checkpoint_orbax
        return checkpoint_orbax.restore(path, like)
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
    return unflatten_like(leaves, like), extra


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
