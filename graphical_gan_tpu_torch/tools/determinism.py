"""Determinism / race audit (``graphical_gan_tpu/tools/determinism.py``).

A nondeterministic kernel, a racy host gather or an unordered prefetch
queue turns "resume from checkpoint" and "reproduce this divergence" into
guesswork. This tool runs each layer of the port's input and step pipeline
twice and demands BIT identity:

1. ``step_replay``     — one step (G+E update and k D updates) from
                         identical state, batches and generator seed: the
                         determinism of the kernels and library ops.
2. ``chunk_replay``    — one dispatch of the trainer's chunked loop
                         (``Trainer.dispatch``): N back-to-back
                         iterations, each drawing its batches on the
                         device from the resident data, replayed from the
                         same state (the state and the N costs the
                         dispatch queued).
3. ``loader_replay``   — two epochs of the host loader at the same seed
                         (``data/common.py: generator_factory``, a numpy
                         gather), byte-compared at the JAX tool's sizes.
4. ``prefetch_order``  — ``data/prefetch.py: prefetch_to_device`` must
                         yield exactly the source order (its worker thread
                         is a reordering hazard).
5. ``trainer_replay``  — two complete short ``Trainer`` runs (resident
                         data, same seed, fresh run dirs): final
                         parameters bit-equal.

Bit-equal means the same tree structure, the same shapes and the same
values, a NaN equal to a NaN. Each check prints one JSON line ``{"check":
..., "ok": ..., "detail": ...}``; the process exits nonzero if any check
fails.

    python -m graphical_gan_tpu_torch.tools.determinism \\
        [--family gan|gmgan|ssgan] [--dataset D] [--dim N] [--batch-size N]
        [--chunk-iters N] [--trainer-iters N] [--device cpu]

Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from graphical_gan_tpu_torch.tools.mfu import device_kind

DEFAULT_DATASET = {"gan": "cifar10", "gmgan": "cifar10",
                   "ssgan": "moving_mnist"}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__
                for x in _leaves(getattr(tree, f))]
    return [tree]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _bit_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(_numpy(x), _numpy(y), equal_nan=True)
        for x, y in zip(la, lb))


def _copy(tree):
    """A deep copy, so the in-place update of one replica cannot reach the
    other."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{f: _copy(getattr(tree, f))
                             for f in tree.__dataclass_fields__})
    return tree


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _build(family: str, dim: int, batch_size: int,
           dataset: Optional[str] = None):
    """(model, cfg, resident numpy data) as JAX's ``_build``: random
    [0, 1) images (16 batches), or 8 batches of LEN-4 videos with one-hot
    labels."""
    dataset = dataset or DEFAULT_DATASET[family]
    rng = np.random.RandomState(0)
    if family == "gan":
        from graphical_gan_tpu_torch.core.config import gan_inference_defaults
        from graphical_gan_tpu_torch.models.gan_inference import (
            GanInferenceModel)
        cfg = gan_inference_defaults(dataset, "wali-gp", dim=dim,
                                     batch_size=batch_size)
        model = GanInferenceModel(cfg)
    elif family == "gmgan":
        from graphical_gan_tpu_torch.core.config import gmgan_defaults
        from graphical_gan_tpu_torch.models.gmgan import GMGanModel
        cfg = gmgan_defaults(dataset, "local_ep", dim=dim,
                             batch_size=batch_size)
        model = GMGanModel(cfg)
    elif family == "ssgan":
        from graphical_gan_tpu_torch.core.config import ssgan_defaults
        from graphical_gan_tpu_torch.models.ssgan import SSGanModel
        cfg = ssgan_defaults(dataset, "local_ep", dim=dim,
                             batch_size=batch_size, seq_len=4)
        model = SSGanModel(cfg)
        resident = {
            "x": rng.rand(8 * batch_size, cfg.seq_len,
                          cfg.data.output_dim).astype("float32"),
            "y": np.eye(cfg.n_classes, dtype="float32")[
                rng.randint(0, cfg.n_classes, size=8 * batch_size)],
        }
        return model, cfg, resident
    else:
        raise ValueError(f"unknown family {family!r}")
    resident = rng.rand(16 * batch_size,
                        cfg.data.output_dim).astype("float32")
    return model, cfg, resident


def check_step_replay(model, cfg, resident, device) -> Dict:
    from graphical_gan_tpu_torch.data.ondevice import sample_batches, to_device
    from graphical_gan_tpu_torch.train.step import make_train_step

    step, init_state = make_train_step(model)
    state = init_state(model.init(0, device))
    raw = sample_batches(to_device(resident, device), 1 + cfg.critic_iters,
                         cfg.batch_size, _generator(7, device))
    s1, m1 = step(_copy(state), _copy(raw), True, _generator(3, device))
    s2, m2 = step(_copy(state), _copy(raw), True, _generator(3, device))
    ok = _bit_equal(s1, s2) and _bit_equal(m1, m2)
    return {"check": "step_replay", "ok": ok,
            "detail": "G+kD step replayed bit-exactly" if ok
            else "replayed step states differ (nondeterministic kernels?)"}


def check_chunk_replay(model, cfg, resident, n_iters: int, device) -> Dict:
    from graphical_gan_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, resident, d, seed=11, device=device,
                     checkpoint_every=0, render_curves=False)
        init = tr.fresh_state()
        runs = []
        for _ in range(2):
            tr.state = _copy(init)
            pend = []
            tr.dispatch(0, n_iters, pend)
            runs.append((tr.state, [v for _, _, v in pend]))
    (s1, m1), (s2, m2) = runs
    ok = _bit_equal(s1, s2) and _bit_equal(m1, m2)
    return {"check": "chunk_replay", "ok": ok,
            "detail": f"a {n_iters}-iteration Trainer dispatch replayed "
            "bit-exactly" if ok else
            "replayed dispatches differ (sampler/step nondeterminism?)"}


def check_loader_replay() -> Dict:
    """Byte-identity of two same-seed epochs at the JAX tool's sizes
    (64 MiB of rows, 1 MiB per batch)."""
    from graphical_gan_tpu_torch.data import common

    rng = np.random.RandomState(5)
    a = rng.rand(4096, 4096).astype("float32")
    y = rng.randint(0, 10, size=4096)
    f1 = common.generator_factory(64, a, y, seed=123)
    f2 = common.generator_factory(64, a, y, seed=123)
    for i, (b1, b2) in enumerate(zip(f1(), f2())):
        for x1, x2 in zip(b1, b2):
            if x1.tobytes() != x2.tobytes():
                return {"check": "loader_replay", "ok": False,
                        "detail": f"epoch batch {i} differs between "
                        "same-seed replays (host gather race?)"}
    return {"check": "loader_replay", "ok": True,
            "detail": "same-seed epochs byte-identical through the numpy "
            "gather"}


def check_prefetch_order(device) -> Dict:
    from graphical_gan_tpu_torch.data import prefetch

    rng = np.random.RandomState(9)
    src = [rng.rand(8, 32).astype("float32") for _ in range(64)]
    it = prefetch.prefetch_to_device(iter(src), size=2, device=device)
    n = 0
    try:
        for i, got in enumerate(it):
            if not np.array_equal(got.cpu().numpy(), src[i]):
                return {"check": "prefetch_order", "ok": False,
                        "detail": f"prefetched batch {i} out of order"}
            n = i + 1
    finally:
        it.close()
    ok = n == len(src)
    return {"check": "prefetch_order", "ok": ok,
            "detail": f"{n}/{len(src)} batches in source order" if ok
            else f"prefetch dropped batches ({n}/{len(src)})"}


def trainer_params(model, resident, iters: int, device, seed: int = 42
                   ) -> Dict[str, np.ndarray]:
    """The final parameters, as numpy, of an ``iters``-iteration Trainer
    run from ``seed`` on resident data in a fresh run directory."""
    from graphical_gan_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, resident, d, seed=seed, device=device,
                     checkpoint_every=0)
        tr.train(iters)
        return {n: _numpy(p) for n, p in tr.params.items()}


def check_trainer_replay(model, cfg, resident, iters: int, device) -> Dict:
    finals = [trainer_params(model, resident, iters, device)
              for _ in range(2)]
    ok = _bit_equal(finals[0], finals[1])
    return {"check": "trainer_replay", "ok": ok,
            "detail": f"two {iters}-iteration Trainer runs ended "
            "bit-identical" if ok else
            "same-seed Trainer runs diverged (system nondeterminism)"}


def run_all(family: str = "gan", dim: int = 16, batch_size: int = 8,
            chunk_iters: int = 4, trainer_iters: int = 6, device="cuda",
            dataset: Optional[str] = None) -> List[Dict]:
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    dev = resolve_device(device)
    set_numerics()
    model, cfg, resident = _build(family, dim, batch_size, dataset)
    return [
        check_step_replay(model, cfg, resident, dev),
        check_chunk_replay(model, cfg, resident, chunk_iters, dev),
        check_loader_replay(),
        check_prefetch_order(dev),
        check_trainer_replay(model, cfg, resident, trainer_iters, dev),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="gan",
                   choices=["gan", "gmgan", "ssgan"])
    p.add_argument("--dataset", default=None,
                   help="the family's dataset (default: cifar10, or "
                        "moving_mnist for ssgan)")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--chunk-iters", type=int, default=4)
    p.add_argument("--trainer-iters", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    results = run_all(args.family, args.dim, args.batch_size,
                      args.chunk_iters, args.trainer_iters, args.device,
                      args.dataset)
    dev = torch.device(args.device)
    for r in results:
        r.update(family=args.family, backend=dev.type,
                 device_kind=device_kind(dev))
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
