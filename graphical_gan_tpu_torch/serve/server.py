"""Dynamic-batching inference server (``graphical_gan_tpu/serve/server.py``).

The same runtime as the JAX package's: a request queue, a bucketed dynamic
batcher and a stdlib HTTP front, around an entry of a trained run directory
(``serve/export.py``) that runs on the card through the port's kernels.

- **Fixed buckets.** Requests are coalesced and padded up to the smallest
  configured bucket (default 8, 64, 256); a request larger than the largest
  bucket straddles several dispatches and is reassembled in order.
- **Padding policy.** The generator and extractor use batch-statistics BN at
  serving time (faithful to the reference), so a row's output depends on its
  co-batched rows. Latent entries pad with **prior-distributed latents**, so
  the dispatched batch keeps the distribution the model always samples
  under; image entries have no server-side prior and pad by **cycling the
  pending rows**. In ``batched`` mode a response is therefore a true sample
  but not bit-reproducible across coalescings; ``exact`` mode dispatches a
  request alone and unpadded, with draws that depend only on its seed.
- **Seeds.** Prior draws come from ``numpy.random.Generator`` seeded by the
  request seed (pad rows: by the server's base seed and the dispatch
  counter), so a seed gives other latents than the JAX server's
  ``jax.random`` draws; what an image entry's model draws (celeba's
  dequantization noise, a stochastic posterior's eps) comes from a
  ``torch.Generator`` seeded with the dispatch's seed. Outputs are returned
  as float32.

CLI::

    python -m graphical_gan_tpu_torch.serve.server --run-dir R \\
        --entry {sampler,encoder,reconstructor,cluster} [--device cpu] \\
        [--quantize int8]
    python -m graphical_gan_tpu_torch.serve.server --export-dir R/export

The entry runs on ``cuda`` unless ``--device cpu`` is given; without a card
it refuses to start. ``--compile-cache DIR`` (or ``GGAN_COMPILE_CACHE``)
builds and loads the CUDA kernel library in DIR before the entry is built
(``core/compile_cache.py``), so a replica pointing at a shared directory
starts with no ``nvcc`` run. ``--quantize int8`` serves the sampler
entry through the int8 path (``ops/quant.py``, the Q1/Q2 kernels), its
activation scales calibrated on prior latents from seed 11
(``serve/quantize.py``), as the JAX server does. ``--export-dir`` serves
an artifact of ``serve/export.py`` instead of a run directory: the
program and its manifest, no model code, on the device it was exported on.

``--dp-devices N`` (JAX ``serve/server.py:158-168, 396-455, 584-617``)
serves one replica over N ranks, launched as the training CLIs are::

    torchrun --nproc-per-node 2 -m graphical_gan_tpu_torch.serve.server \
        --run-dir R --dp-devices 2

Rank 0 runs the HTTP front and the batcher and broadcasts each dispatch's
seed and inputs at the global batch; every rank runs its block of rows
under the data-parallel context (``parallel/context.py``), so the
batch-statistics BNs reduce over the whole dispatched batch (K2a's split
mode, also on the int8 path where K2b writes the int8 copy) and a draw
is made at the global batch and cut; rank 0 gathers the rows in order.
The outputs equal one rank's up to the reduction order of the statistics.
Every bucket, and every exact-mode request, must divide by N; the
run-directory backend only (``--export-dir`` is refused). NCCL on
``cuda:{LOCAL_RANK}``, gloo with ``--device cpu``.

HTTP surface (identical to the JAX server's; see ``serve/client.py``):

- ``POST /sample``: body either JSON ``{"n": int, "seed": int, "exact":
  bool}`` (server draws prior latents from the seed) or an ``.npz`` payload
  whose arrays ``input0, input1, ...`` are the entry's inputs, with the
  ``X-GGAN-Exact: 1`` and ``X-GGAN-Seed`` headers. Response: ``.npz`` keyed
  by the entry's output name (``images`` kept as an alias), ``X-GGAN-Meta``
  header with the mode and latency.
- ``GET /healthz``: liveness + model identity.
- ``GET /stats``: batching counters and latency percentiles.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


# --------------------------------------------------------------------------
# prior input descriptions (what to draw for server-side latents / padding)

def input_kinds(family: str, cfg) -> List[str]:
    """Per-input prior kind, aligned with ``serve.export.make_sampler``:
    ``"normal"`` (an N(0, 1) latent) or ``"onehot"`` (a uniform
    component)."""
    if family == "gan_inference":
        return ["normal"]
    if family == "gmgan":
        return ["onehot", "normal"]
    if family == "ssgan":
        return ["normal", "normal"] + (["onehot"] if cfg.conditional else [])
    raise ValueError(f"unknown family {family!r}")


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), as ``jax.random.fold_in``
    derives a key."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1]))


def _draw_prior(kinds: Sequence[str], shapes: Sequence[Tuple[int, ...]],
                n: int, seed: int) -> Tuple[np.ndarray, ...]:
    """Prior-distributed input rows, drawn on the host from one
    ``numpy.random.Generator`` seeded with ``seed``, input by input: a
    one-hot row of a uniform component, or N(0, 1) rows."""
    rng = np.random.default_rng(int(seed))
    out = []
    for kind, shape in zip(kinds, shapes):
        if kind == "onehot":
            k = int(shape[1])
            out.append(np.eye(k, dtype=np.float32)[rng.integers(0, k, n)])
        elif kind == "image":
            raise ValueError(
                "this entry takes image inputs; POST an npz payload "
                "(input0, ...) instead of a seeded JSON request")
        else:
            out.append(rng.standard_normal(
                (n,) + tuple(shape[1:]), dtype=np.float32))
    return tuple(out)


# --------------------------------------------------------------------------
# batching core

@dataclass
class _Request:
    inputs: Tuple[np.ndarray, ...]
    n: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    filled: int = 0
    parts: List[Tuple[int, np.ndarray]] = field(default_factory=list)
    t_enq: float = 0.0
    latency_ms: float = 0.0

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("sampler request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class BatchingSampler:
    """Coalesce concurrent requests into fixed-bucket device batches.

    ``call(seed, *inputs) -> ndarray`` is the served entry. Requests may
    straddle dispatch boundaries: the batcher packs up to ``max(buckets)``
    rows per dispatch, pads the rest to the smallest fitting bucket (prior
    draws, or cycled rows for image entries) and scatters output rows back
    to their requests.
    """

    def __init__(self, call, kinds: Sequence[str],
                 input_shapes: Sequence[Tuple[int, ...]],
                 buckets: Sequence[int] = (8, 64, 256),
                 max_wait_ms: float = 5.0, base_seed: int = 0,
                 dp_devices: int = 1):
        self.call = call
        self.kinds = list(kinds)
        self.input_shapes = [tuple(s) for s in input_shapes]
        self.buckets = sorted(set(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"need positive bucket sizes, got {buckets}")
        self.dp = max(int(dp_devices), 1)
        if any(b % self.dp for b in self.buckets):
            raise ValueError(
                f"every bucket must be divisible by dp_devices={self.dp} "
                f"(got {self.buckets}): dispatched batches split over the "
                "ranks")
        self.max_wait = max_wait_ms / 1e3
        self.base_seed = int(base_seed)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._batch_counter = 0
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0, "rows": 0, "batches": 0, "padded_rows": 0,
            "exact_requests": 0,
            "bucket_hist": {str(b): 0 for b in self.buckets},
        }
        self._latencies: List[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ggan-batcher")
        self._thread.start()

    # -- public API ---------------------------------------------------------

    def _inputs(self, inputs, n, seed) -> Tuple[np.ndarray, ...]:
        if inputs is None:
            if n is None:
                raise ValueError("pass inputs or n")
            inputs = _draw_prior(self.kinds, self.input_shapes, int(n),
                                 int(seed))
        inputs = tuple(np.asarray(a, np.float32) for a in inputs)
        rows = inputs[0].shape[0]
        if rows == 0:
            raise ValueError("request has zero rows; send at least one")
        for a, shape in zip(inputs, self.input_shapes):
            if a.shape[0] != rows or a.shape[1:] != shape[1:]:
                raise ValueError(
                    f"input shape {a.shape} does not match sampler spec "
                    f"(batch, {shape[1:]})")
        return inputs

    def submit(self, inputs: Optional[Sequence[np.ndarray]] = None,
               n: Optional[int] = None, seed: int = 0) -> _Request:
        """Enqueue a request; returns a waitable ``_Request``.

        Either pass explicit ``inputs`` (arrays in entry order, shared
        leading batch dim) or ``n`` + ``seed`` for server-drawn priors.
        """
        inputs = self._inputs(inputs, n, seed)
        if self._stop.is_set():
            raise RuntimeError("BatchingSampler is closed")
        req = _Request(inputs=inputs, n=inputs[0].shape[0],
                       t_enq=time.perf_counter())
        with self._lock:
            self.stats["requests"] += 1
            self.stats["rows"] += req.n
        self._q.put(req)
        return req

    def sample_exact(self, inputs: Optional[Sequence[np.ndarray]] = None,
                     n: Optional[int] = None, seed: int = 0) -> np.ndarray:
        """Reproducible path: dispatch this request alone, unpadded, with
        draws that depend only on ``seed``."""
        inputs = self._inputs(inputs, n, seed)
        if inputs[0].shape[0] % self.dp:
            raise ValueError(
                f"an exact-mode request of {inputs[0].shape[0]} rows does "
                f"not divide over dp_devices={self.dp}: it dispatches "
                "unpadded")
        out = self.call(int(seed), *inputs)
        with self._lock:
            self.stats["exact_requests"] += 1
        return out

    def warmup(self) -> None:
        """Run every bucket once before taking traffic (on the card this
        also builds the kernels)."""
        for b in self.buckets:
            self.call(1, *self._warmup_inputs(b))

    def _warmup_inputs(self, n: int) -> Tuple[np.ndarray, ...]:
        """Shape-correct inputs whose values never reach a client: prior
        draws for latent kinds, zeros for image kinds."""
        out = []
        for i, (kind, shape) in enumerate(zip(self.kinds, self.input_shapes)):
            if kind == "image":
                out.append(np.zeros((n,) + tuple(shape[1:]), np.float32))
            else:
                out.append(_draw_prior([kind], [shape], n, fold_in(1, i))[0])
        return tuple(out)

    def snapshot(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies[-4096:])
            s = dict(self.stats, bucket_hist=dict(self.stats["bucket_hist"]))
        if lat:
            s["latency_ms_p50"] = round(lat[len(lat) // 2], 3)
            s["latency_ms_p95"] = round(lat[int(len(lat) * 0.95)], 3)
        if s["batches"]:
            dispatched = s["rows"] + s["padded_rows"]
            s["fill_ratio"] = round(s["rows"] / max(dispatched, 1), 4)
            s["rows_per_batch"] = round(s["rows"] / s["batches"], 2)
        return s

    def close(self) -> None:
        """Stop the loop; an entry served over several ranks
        (:class:`DataParallelEntry`) ends their loops too."""
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)
        stop = getattr(self.call, "stop", None)
        if stop is not None:
            stop()

    # -- batcher loop --------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for one request, then coalesce arrivals for max_wait or
        until a full max-bucket of rows is pending."""
        first = self._q.get()
        if first is None:
            return []
        batch, rows = [first], first.n
        deadline = time.perf_counter() + self.max_wait
        cap = self.buckets[-1]
        while rows < cap:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                req = self._q.get(timeout=remain)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # re-post the sentinel for shutdown
                break
            batch.append(req)
            rows += req.n
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                if self._stop.is_set():
                    break
                continue
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — surface to every waiter
                for req in batch:
                    if not req.done.is_set():
                        req.error = e
                        req.done.set()

    def _dispatch(self, batch: List[_Request]) -> None:
        # flatten pending rows; requests may straddle device batches
        pending: List[Tuple[_Request, int, int]] = [
            (req, req.filled, req.n) for req in batch]
        i = 0
        cap = self.buckets[-1]
        while i < len(pending):
            chunk: List[Tuple[_Request, int, int]] = []
            rows = 0
            while i < len(pending) and rows < cap:
                req, start, stop = pending[i]
                take = min(stop - start, cap - rows)
                chunk.append((req, start, start + take))
                rows += take
                if start + take < stop:
                    pending[i] = (req, start + take, stop)
                else:
                    i += 1
            bucket = next(b for b in self.buckets if b >= rows)
            pad = bucket - rows
            with self._lock:
                self._batch_counter += 1
                counter = self._batch_counter
                self.stats["batches"] += 1
                self.stats["padded_rows"] += pad
                self.stats["bucket_hist"][str(bucket)] += 1
            parts = [np.concatenate(
                [req.inputs[j][a:b] for req, a, b in chunk], axis=0)
                for j in range(len(self.input_shapes))]
            seed = fold_in(self.base_seed, counter)
            if pad:
                if "image" in self.kinds:
                    # image entries: no prior to draw from, so pad by
                    # cycling the pending rows; the padded batch stays
                    # data-distributed under batch-statistics BN
                    wrap = np.arange(rows, bucket) % rows
                    parts = [np.concatenate([p, p[wrap]], axis=0)
                             for p in parts]
                else:
                    extra = _draw_prior(self.kinds, self.input_shapes, pad,
                                        seed)
                    parts = [np.concatenate([p, e], axis=0)
                             for p, e in zip(parts, extra)]
            out = self.call(seed, *parts)
            off = 0
            now = time.perf_counter()
            for req, a, b in chunk:
                req.parts.append((a, out[off:off + (b - a)]))
                off += b - a
                req.filled += b - a
                if req.filled == req.n:
                    res = np.empty((req.n,) + out.shape[1:], out.dtype)
                    for start, arr in req.parts:
                        res[start:start + arr.shape[0]] = arr
                    req.result, req.parts = res, []
                    req.latency_ms = (now - req.t_enq) * 1e3
                    with self._lock:
                        self._latencies.append(req.latency_ms)
                        if len(self._latencies) > 8192:  # bound memory
                            del self._latencies[:4096]
                    req.done.set()


# --------------------------------------------------------------------------
# backend

class DataParallelEntry:
    """An entry served over the ranks of a 1-D ``data`` mesh
    (``--dp-devices``). ``call(seed, *inputs)`` on rank 0 broadcasts the
    dispatch (a header over the host group, the inputs over the world),
    runs rank 0's block of rows and returns every rank's rows in order;
    :meth:`serve` is the other ranks' loop, which :meth:`stop` (rank 0)
    ends."""

    def __init__(self, fn, params, mesh, input_shapes):
        self.fn, self.params, self.mesh = fn, params, mesh
        self.group = mesh.group("data")
        self.rank = mesh.rank
        self.size = mesh.size
        self.input_shapes = [tuple(s) for s in input_shapes]
        self._lock = threading.Lock()
        self._stopped = False

    def _head(self, values=None) -> List[int]:
        from graphical_gan_tpu_torch.parallel.collectives import broadcast
        head = torch.tensor(values or [0, 0, 0], dtype=torch.int64)
        return broadcast(head, self.mesh.host).tolist()

    def _run(self, seed: int, inputs: List[torch.Tensor]) -> torch.Tensor:
        from graphical_gan_tpu_torch.parallel import context
        from graphical_gan_tpu_torch.parallel.collectives import (
            broadcast, gather_stack)
        for t in inputs:
            broadcast(t, self.mesh.world)
        n = inputs[0].shape[0]
        k, i = n // self.size, self.group.index
        own = [t[i * k:(i + 1) * k] for t in inputs]
        with context.sharding(context.Sharding(rows=self.group,
                                               stats=self.group)), \
                torch.inference_mode():
            out = self.fn(self.params, seed, *own).float().contiguous()
        rows = gather_stack(out, self.group)
        return rows.reshape((n,) + tuple(out.shape[1:]))

    def __call__(self, seed: int, *inputs: np.ndarray) -> np.ndarray:
        n = inputs[0].shape[0]
        if n % self.size:
            raise ValueError(f"a dispatch of {n} rows does not divide over "
                             f"{self.size} ranks")
        with self._lock:
            self._head([1, int(seed), n])
            ts = [torch.tensor(a, dtype=torch.float32,
                               device=self.mesh.device) for a in inputs]
            return self._run(int(seed), ts).cpu().numpy()

    def serve(self) -> int:
        """A rank > 0's loop: each dispatch rank 0 broadcasts, until
        :meth:`stop`; returns the dispatches served."""
        served = 0
        while True:
            go, seed, n = self._head()
            if not go:
                return served
            ts = [torch.empty((n,) + shape[1:], dtype=torch.float32,
                              device=self.mesh.device)
                  for shape in self.input_shapes]
            self._run(seed, ts)
            served += 1

    def stop(self) -> None:
        """Rank 0: end the other ranks' loops (once)."""
        if self.rank == 0:
            with self._lock:
                if not self._stopped:
                    self._stopped = True
                    self._head([0, 0, 0])


def sampler_from_run_dir(run_dir: str, entry: str = "sampler",
                         device: Union[str, torch.device] = "cuda",
                         ckpt: Optional[str] = None,
                         quantize: Optional[str] = None,
                         dp_devices: Optional[int] = None, mesh=None):
    """(call, kinds, input_shapes, identity) from a trained run directory.

    ``call(seed, *inputs)`` takes numpy inputs, runs the entry on
    ``device`` (``cuda`` unless the caller asks for ``cpu``; a missing card
    raises) and returns a float32 numpy array. Calls are serialized.
    ``quantize="int8"`` calibrates the sampler (seed 11) and serves it on
    the int8 path (JAX ``serve/server.py:423-436``). ``dp_devices=N > 1``
    (or a ``data`` ``mesh`` of N ranks) serves over N ranks, one process
    each: ``call`` is then a :class:`DataParallelEntry` on every rank,
    rank 0's to call and the others' to :meth:`~DataParallelEntry.serve`
    (JAX ``serve/server.py:396-455``), and ``identity["dp_devices"]`` is
    N.
    """
    from graphical_gan_tpu_torch.core.device import (
        resolve_device, set_numerics)
    from graphical_gan_tpu_torch.serve.export import ENTRY_OUTPUT, make_entry
    from graphical_gan_tpu_torch.tools.generate import rebuild, restore_params
    from graphical_gan_tpu_torch.train import checkpoint as ckpt_lib

    dev = resolve_device(device)
    if mesh is None and dp_devices and dp_devices > 1:
        from graphical_gan_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(dp_devices, device=dev.type)
    if mesh is not None:
        dev = mesh.device
    set_numerics()
    family, cfg, model = rebuild(run_dir)
    path = ckpt or ckpt_lib.latest(run_dir)
    if path is None:
        raise FileNotFoundError(f"no ckpt_*.npz under {run_dir}")
    params, extra = restore_params(model, path, dev)
    fn, example, kinds = make_entry(family, model, entry)
    if quantize == "int8":
        if entry != "sampler":
            raise ValueError("--quantize int8 calibrates on prior latents "
                             "and applies to the sampler entry only")
        from graphical_gan_tpu_torch.serve.quantize import (
            calibrate, quantized_entry)
        fn = quantized_entry(fn, calibrate(family, model, params, 11))
    elif quantize not in (None, "none"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    identity = {"family": family, "entry": entry, "backend": "run_dir",
                "output": ENTRY_OUTPUT.get(entry, "images"),
                "checkpoint": os.path.basename(path),
                "iteration": int(extra.get("iteration", -1)),
                "quantization": quantize or "none", "device": str(dev),
                "compute_dtype": cfg.compute_dtype}
    shapes = [tuple(a.shape) for a in example]
    if mesh is not None:
        identity["dp_devices"] = mesh.size
        return DataParallelEntry(fn, params, mesh, shapes), kinds, shapes, \
            identity
    lock = threading.Lock()

    def call(seed: int, *inputs: np.ndarray) -> np.ndarray:
        with lock, torch.inference_mode():
            ts = [torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in inputs]
            return fn(params, seed, *ts).float().cpu().numpy()

    return call, kinds, shapes, identity


def sampler_from_export(export_dir: str):
    """(call, kinds, input_shapes, identity) from an export directory
    (``serve/export.py``): the program and its manifest alone, with no
    model code, so it serves artifacts made elsewhere, int8 ones included.
    The program runs on the device it was exported on."""
    from graphical_gan_tpu_torch.serve.export import load_sampler

    with open(os.path.join(export_dir, "manifest.json")) as f:
        manifest = json.load(f)
    program = load_sampler(os.path.join(export_dir, manifest["blob"]))
    lock = threading.Lock()

    def call(seed: int, *inputs: np.ndarray) -> np.ndarray:
        with lock:
            return program(seed, *inputs).float().cpu().numpy()

    kinds = [inp.get("prior", "normal") for inp in manifest["inputs"]]
    shapes = [tuple(inp["shape"]) for inp in manifest["inputs"]]
    identity = {"family": manifest["family"], "backend": "export",
                "entry": manifest.get("entry", "sampler"),
                "output": manifest.get("output", "images"),
                "iteration": manifest.get("iteration", -1),
                "quantization": manifest.get("quantization", "none"),
                "symbolic_batch": manifest.get("symbolic_batch", False),
                "device": manifest["device"]}
    return call, kinds, shapes, identity


# --------------------------------------------------------------------------
# HTTP front

def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_http_server(batcher: BatchingSampler, identity: Dict,
                     host: str = "127.0.0.1", port: int = 0,
                     request_timeout: float = 120.0) -> ThreadingHTTPServer:
    """A ``ThreadingHTTPServer`` wired to the batcher; the caller runs
    ``serve_forever`` (CLI) or drives it from a thread (tests)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live at /stats
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **identity})
            elif self.path == "/stats":
                self._json(200, batcher.snapshot())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                exact = False
                if "json" in ctype:
                    spec = json.loads(raw.decode())
                    exact = bool(spec.get("exact", False))
                    kw = dict(n=int(spec.get("n", 1)),
                              seed=int(spec.get("seed", 0)))
                else:  # npz payload: input0, input1, ... in entry order
                    data = np.load(io.BytesIO(raw))
                    inputs = [data[f"input{i}"]
                              for i in range(len(batcher.input_shapes))]
                    exact = self.headers.get("X-GGAN-Exact", "") == "1"
                    kw = dict(
                        inputs=inputs,
                        seed=int(self.headers.get("X-GGAN-Seed", "0")))
                out_name = identity.get("output", "images")
                if exact:
                    images = batcher.sample_exact(**kw)
                    meta = {"mode": "exact", "output": out_name}
                else:
                    req = batcher.submit(**kw)
                    images = req.wait(timeout=request_timeout)
                    meta = {"mode": "batched", "output": out_name,
                            "latency_ms": round(req.latency_ms, 3)}
            except Exception as e:  # noqa: BLE001 — report to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            # key the array by the entry's declared output; 'images' stays
            # as an alias so existing clients keep working
            arrays = {out_name: images}
            arrays.setdefault("images", images)
            body = _npz_bytes(**arrays)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-GGAN-Meta", json.dumps(meta))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def serve_run_dir(run_dir: Optional[str] = None, entry: str = "sampler",
                  device: Union[str, torch.device] = "cuda",
                  ckpt: Optional[str] = None,
                  buckets: Sequence[int] = (8, 64, 256),
                  max_wait_ms: float = 5.0, host: str = "127.0.0.1",
                  port: int = 8787, warmup: bool = True,
                  quantize: Optional[str] = None,
                  export_dir: Optional[str] = None,
                  dp_devices: int = 1, mesh=None):
    """(httpd, batcher, identity, warmup_s): the server ``main`` runs, not
    yet serving, over ``run_dir`` or, given ``export_dir``, an exported
    program (which carries its entry, quantization and device); the caller
    runs ``httpd.serve_forever()`` and, at the end, ``httpd.server_close()``
    and ``batcher.close()``. With ``dp_devices`` > 1 (over ``mesh``, or
    one made from torchrun's environment) this is rank 0's (the other
    ranks run :func:`serve_ranks`); ``batcher.close()`` ends theirs."""
    if export_dir is not None:
        if dp_devices > 1:
            raise ValueError("--dp-devices applies to the run-dir backend "
                             "(an export artifact runs where it was made)")
        call, kinds, shapes, identity = sampler_from_export(export_dir)
    else:
        call, kinds, shapes, identity = sampler_from_run_dir(
            run_dir, entry=entry, device=device, ckpt=ckpt,
            quantize=quantize, dp_devices=dp_devices, mesh=mesh)
    batcher = BatchingSampler(call, kinds, shapes, buckets=buckets,
                              max_wait_ms=max_wait_ms, dp_devices=dp_devices)
    warmup_s = None
    try:
        if warmup:
            t0 = time.perf_counter()
            batcher.warmup()
            warmup_s = time.perf_counter() - t0
        httpd = make_http_server(batcher, identity, host=host, port=port)
    except BaseException:
        batcher.close()
        raise
    return httpd, batcher, identity, warmup_s


def serve_ranks(run_dir: str, mesh, entry: str = "sampler",
                device: Union[str, torch.device] = "cuda",
                ckpt: Optional[str] = None, quantize: Optional[str] = None
                ) -> int:
    """A rank > 0 of a ``--dp-devices`` server: its entry, then its
    share of every dispatch until rank 0 closes; the dispatches served."""
    call, _, _, _ = sampler_from_run_dir(run_dir, entry=entry, device=device,
                                         ckpt=ckpt, quantize=quantize,
                                         mesh=mesh)
    return call.serve()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir",
                     help="trained run directory (config.json + ckpt_*.npz)")
    src.add_argument("--export-dir",
                     help="serve a torch.export artifact directory "
                          "(serve/export.py; <entry>.pt2 + manifest.json)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--entry", default="sampler",
                   choices=["sampler", "encoder", "reconstructor",
                            "cluster"],
                   help="which network to serve: the generator sampler, or "
                        "the inference side (encoder x->z, reconstructor "
                        "x->G(E(x)), gmgan's cluster x->q(k|x)). "
                        "Image-input entries take npz payloads only")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of "
                        "the kernels)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--buckets", default="8,64,256",
                   help="fixed batch buckets")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket before serving")
    p.add_argument("--quantize", default=None, choices=["none", "int8"],
                   help="int8 PTQ path (ops/quant.py; sampler entry only)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build and load the CUDA kernel library in DIR "
                        "(also GGAN_COMPILE_CACHE; the flag wins)")
    p.add_argument("--dp-devices", type=int, default=1,
                   help="serve over N ranks, one process each (launch with "
                        "`torchrun --nproc-per-node N -m ...`): each "
                        "dispatch's rows split over them, BN over the whole "
                        "batch; run-dir backend; buckets must divide by N")
    args = p.parse_args(argv)
    if args.export_dir and (args.quantize or args.ckpt
                            or args.entry != "sampler"):
        p.error("--export-dir serves the artifact as exported; --quantize, "
                "--ckpt and --entry belong to --run-dir")
    if args.export_dir and args.dp_devices > 1:
        p.error("--dp-devices applies to the run-dir backend (an export "
                "artifact runs where it was made)")
    from graphical_gan_tpu_torch.core import compile_cache
    compile_cache.enable_compile_cache(args.compile_cache)
    mesh = None
    if args.dp_devices > 1:
        import torch.distributed as dist
        from graphical_gan_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.dp_devices, device=args.device)
        if mesh.rank != 0:
            serve_ranks(args.run_dir, mesh, entry=args.entry,
                        device=args.device, ckpt=args.ckpt,
                        quantize=args.quantize)
            dist.destroy_process_group()
            return 0

    httpd, batcher, identity, warmup_s = serve_run_dir(
        args.run_dir, entry=args.entry, device=args.device, ckpt=args.ckpt,
        buckets=[int(b) for b in args.buckets.split(",")],
        max_wait_ms=args.max_wait_ms, host=args.host, port=args.port,
        warmup=not args.no_warmup, quantize=args.quantize,
        export_dir=args.export_dir, dp_devices=args.dp_devices, mesh=mesh)
    if warmup_s is not None:
        print(json.dumps({"warmup_s": round(warmup_s, 3),
                          "buckets": batcher.buckets}), flush=True)
    print(json.dumps({"serving": True, "host": args.host,
                      "port": httpd.server_address[1], **identity}),
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
