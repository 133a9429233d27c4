"""Sharded checkpoints (``graphical_gan_tpu/train/checkpoint_orbax.py``):
a ``ckpt_<step>.orbax`` directory that each rank writes its own part of.

The flag (``--checkpoint-backend orbax``, ``Trainer(checkpoint_backend=
"orbax")``) and the ``.orbax`` suffix keep the JAX package's names; the
content is ``torch.distributed.checkpoint``'s (``FileSystemWriter``: a
``.metadata`` file and one ``.distcp`` file per rank), not orbax's: the
port's machines have neither orbax nor tensorstore. A directory JAX's
orbax wrote (OCDBT) is refused with a message that names the npz route.

The leaves are the npz format's keypaths (``train/checkpoint.py:
state_leaves``). A leaf a rank holds in a slice (TP's and EP's sliced
parameters and their optimizer leaves, a pipeline stage's row; the step's
``shard_spec``) is written by its owner under ``<keypath>@<dim>:<index>/
<count>``; a leaf every rank holds is written once (the planner keeps one
copy of a key several ranks hold). :func:`restore` reads any such
directory into the full logical arrays of ``like``, every rank on its own
(no collective): the caller places them (``place`` cuts a rank's slices
again), so a directory written at one layout resumes at any other, one
device included.

``<path>.extra.json``, the metadata, is written beside the directory by
rank 0 after every rank's part is committed; ``train/checkpoint.py:
list_checkpoints`` and ``remove`` treat a directory without it as an
interrupted save.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

#: keypath -> (dim, index, count) of the leaves a rank holds in slices
ShardSpec = Dict[str, Tuple[int, int, int]]


def extra_path(path: str) -> str:
    return path.rstrip("/") + ".extra.json"


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _shard_key(keypath: str, spec: Tuple[int, int, int]) -> str:
    dim, index, count = spec
    return f"{keypath}@{dim}:{index}/{count}"


def _parse(key: str) -> Tuple[str, Optional[Tuple[int, int, int]]]:
    if "@" not in key:
        return key, None
    keypath, spec = key.rsplit("@", 1)
    dim, rest = spec.split(":")
    index, count = rest.split("/")
    return keypath, (int(dim), int(index), int(count))


def save(path: str, state: Any, extra: Optional[Dict] = None,
         shards: Optional[ShardSpec] = None) -> str:
    """Write ``state`` (a TrainState or a pipeline state, this rank's
    part of it) and ``extra``. In a process group every rank calls it;
    ``shards`` names the leaves this rank holds in slices."""
    import torch.distributed.checkpoint as dcp
    from graphical_gan_tpu_torch.train.checkpoint import state_leaves
    path = os.path.abspath(path)
    dist = _dist()
    rank = dist.get_rank() if dist else 0
    if rank == 0 and os.path.exists(extra_path(path)):
        os.unlink(extra_path(path))  # a rewrite is unfinished until done
    sd = {}
    for key, leaf in state_leaves(state).items():
        spec = (shards or {}).get(key)
        sd[key if spec is None else _shard_key(key, spec)] = \
            torch.as_tensor(leaf).detach().contiguous()
    os.makedirs(path, exist_ok=True)
    with warnings.catch_warnings():  # one process is meant where no group
        warnings.filterwarnings("ignore", message=".*single process")
        dcp.save(sd, storage_writer=dcp.FileSystemWriter(path),
                 no_dist=dist is None)
    if rank == 0:
        tmp = extra_path(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(extra or {}, f)
        os.replace(tmp, extra_path(path))
    return path


def _metadata(path: str):
    import torch.distributed.checkpoint as dcp
    if not os.path.isfile(os.path.join(path, ".metadata")):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, n)) for n in
                ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                 "ocdbt.process_0")):
            raise ValueError(
                f"{path!r} was written by JAX's orbax (OCDBT, which needs "
                "tensorstore); the port reads torch.distributed.checkpoint "
                "directories only. Take the npz route: resume the run in "
                "JAX with --checkpoint-backend npz (or restore it there and "
                "checkpoint.save it to a .npz), and the port reads that")
        raise ValueError(f"{path!r} is no torch.distributed.checkpoint "
                         "directory (no .metadata)")
    return dcp.FileSystemReader(path).read_metadata()


def leaf_shapes(path: str) -> Dict[str, Tuple[int, ...]]:
    """keypath -> the full logical shape of each leaf in the directory."""
    out: Dict[str, list] = {}
    for key, meta in _metadata(os.path.abspath(path)) \
            .state_dict_metadata.items():
        keypath, spec = _parse(key)
        size = list(meta.size)
        if spec is None:
            out[keypath] = size
        else:
            dim, _, count = spec
            whole = out.setdefault(keypath, list(size))
            whole[dim] = size[dim] * count
    return {k: tuple(v) for k, v in out.items()}


def read_leaves(path: str, keypaths) -> Dict[str, torch.Tensor]:
    """keypath -> the whole leaf (its slices put together), on the CPU
    in its stored dtype; a leaf missing raises. Runs on each rank alone
    (no collective)."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    parts: Dict[str, Dict] = {}
    for key, meta in _metadata(path).state_dict_metadata.items():
        keypath, spec = _parse(key)
        parts.setdefault(keypath, {})[key] = (spec, meta)
    sd = {}
    for keypath in keypaths:
        if keypath not in parts:
            raise KeyError(f"checkpoint {path!r} missing leaf {keypath!r}")
        for key, (_, meta) in parts[keypath].items():
            sd[key] = torch.empty(tuple(meta.size),
                                  dtype=meta.properties.dtype)
    with warnings.catch_warnings():  # each rank reads on its own
        warnings.filterwarnings("ignore", message=".*single process")
        dcp.load(sd, storage_reader=dcp.FileSystemReader(path),
                 no_dist=True)
    out = {}
    for keypath in keypaths:
        pieces = parts[keypath]
        whole = [k for k, (spec, _) in pieces.items() if spec is None]
        if whole:
            out[keypath] = sd[whole[0]]
            continue
        specs = sorted((spec[1], spec, k) for k, (spec, _) in pieces.items())
        dim, _, count = specs[0][1]
        if [s[0] for s in specs] != list(range(count)):
            raise ValueError(f"checkpoint {path!r}: leaf {keypath!r} "
                             "lacks some of its slices")
        out[keypath] = torch.cat([sd[k] for _, _, k in specs], dim=dim)
    return out


def read_extra(path: str) -> Dict:
    if not os.path.exists(extra_path(path)):
        return {}
    with open(extra_path(path)) as f:
        return json.load(f)


def restore(path: str, like: Any) -> Tuple[Any, Dict]:
    """(the full state in the structure of ``like``, extra): each leaf of
    ``like`` read whole (:func:`read_leaves`) onto ``like``'s leaf's
    device and dtype; a leaf missing or of another shape raises. Runs on
    each rank alone."""
    from graphical_gan_tpu_torch.train.checkpoint import (
        state_leaves, unflatten_like)
    want = state_leaves(like)
    got = read_leaves(path, list(want))
    leaves = {}
    for keypath, ref in want.items():
        t, ref = got[keypath], torch.as_tensor(ref)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {keypath!r}: checkpoint "
                             f"{tuple(t.shape)} vs state "
                             f"{tuple(ref.shape)}")
        leaves[keypath] = t.to(device=ref.device, dtype=ref.dtype)
    return unflatten_like(leaves, like), read_extra(path)
