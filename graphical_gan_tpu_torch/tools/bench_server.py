"""Load benchmark of the dynamic-batching HTTP server
(``graphical_gan_tpu/tools/bench_server.py``).

``tools/bench_serving.py`` measures the bare entry; this measures the whole
deployment stack (HTTP front, request queue, dynamic batcher, bucket
padding, the dispatch on the card, response serialization) under
concurrent clients, each sending its requests back to back. The server is
``serve/server.py: serve_run_dir`` (``make_http_server`` over a
``BatchingSampler``) on localhost, over ``--run-dir`` or, without one, a
run directory of random weights from seed 0 at the family's published
config (``tools/bench_serving.py: build``). Reported per request size:
client-observed latency percentiles, samples/s, and the batcher's own
counters (fill ratio, rows per batch, batches), one JSON line each.

    python -m graphical_gan_tpu_torch.tools.bench_server \\
        [--family gan_inference] [--request-sizes 1,8,64] [--clients 16]
        [--requests-per-client 20] [--buckets 8,64,256] [--max-wait-ms 5]
        [--dtype bfloat16] [--run-dir DIR] [--quantize int8] [--device cpu]

``--quantize int8`` serves the sampler on the int8 path, calibrated as the
server calibrates it (``serve/server.py``: seed 11).

Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

from graphical_gan_tpu_torch.tools.mfu import device_kind


def write_run_dir(run_dir: str, family: str, dtype: str = "bfloat16",
                  **overrides) -> str:
    """A run directory the server loads: ``config.json`` and
    ``ckpt_0.npz`` of random weights from seed 0."""
    from graphical_gan_tpu_torch.core.config import asdict
    from graphical_gan_tpu_torch.tools.bench_serving import build
    from graphical_gan_tpu_torch.train.checkpoint import save_params
    model = build(family, dtype, **overrides)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(asdict(model.cfg), f, default=str)
    save_params(os.path.join(run_dir, "ckpt_0.npz"), model.init(0, "cpu"),
                {"iteration": 0})
    return run_dir


def run_load(run_dir: str, request_size: int, clients: int,
             requests_per_client: int, buckets, max_wait_ms: float,
             device="cuda", quantize=None) -> dict:
    from graphical_gan_tpu_torch.core.device import resolve_device
    from graphical_gan_tpu_torch.serve.client import SamplerClient
    from graphical_gan_tpu_torch.serve.server import serve_run_dir
    dev = resolve_device(device)
    httpd, batcher, identity, _ = serve_run_dir(
        run_dir, "sampler", dev, buckets=buckets, max_wait_ms=max_wait_ms,
        port=0, quantize=quantize)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        latencies: list = [None] * clients
        errors: list = []

        def client(i: int):
            try:
                cl = SamplerClient(url)
                lats = []
                for r in range(requests_per_client):
                    t0 = time.perf_counter()
                    out = cl.sample(n=request_size,
                                    seed=i * requests_per_client + r)
                    lats.append(time.perf_counter() - t0)
                    if out.shape[0] != request_size:
                        raise ValueError(f"{out.shape[0]} rows for a "
                                         f"{request_size}-row request")
                latencies[i] = lats
            except Exception as e:  # reported below, in the caller's thread
                errors.append(e)

        # one untimed request primes the HTTP and numpy paths
        SamplerClient(url).sample(n=request_size, seed=0)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]

        flat = sorted(x for ls in latencies for x in ls)
        n_req = clients * requests_per_client
        s = batcher.snapshot()
        family = identity["family"]
        with open(os.path.join(run_dir, "config.json")) as f:
            frames = json.load(f).get("seq_len", 1)
        return {
            "metric": f"{family}_server_throughput",
            "request_size": request_size, "clients": clients,
            "requests": n_req,
            "samples_per_sec": n_req * request_size / wall,
            **({"frames_per_sec": n_req * request_size * frames / wall}
               if frames > 1 else {}),
            "latency_ms_p50": flat[len(flat) // 2] * 1e3,
            "latency_ms_p95": flat[int(len(flat) * 0.95)] * 1e3,
            "latency_ms_max": flat[-1] * 1e3,
            "fill_ratio": s.get("fill_ratio"),
            "rows_per_batch": s.get("rows_per_batch"),
            "batches": s["batches"],
            "buckets": list(batcher.buckets),
            "max_wait_ms": max_wait_ms,
            "compute_dtype": identity["compute_dtype"],
            "quantization": identity["quantization"],
            "device_kind": device_kind(dev),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="gan_inference",
                   choices=["gan_inference", "gmgan", "ssgan"])
    p.add_argument("--request-sizes", default="1,8,64")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests-per-client", type=int, default=20)
    p.add_argument("--buckets", default="8,64,256")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--run-dir", default=None,
                   help="serve a trained run dir (default: random weights "
                        "from seed 0 at the family's published config)")
    p.add_argument("--dim", type=int, default=None,
                   help="override the model width (smoke/testing)")
    p.add_argument("--quantize", default=None, choices=["none", "int8"],
                   help="serve the int8 PTQ sampler (ops/quant.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    buckets = [int(b) for b in args.buckets.split(",")]
    overrides = {} if args.dim is None else {"dim": args.dim}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = args.run_dir or write_run_dir(
            os.path.join(tmp, "run"), args.family, args.dtype, **overrides)
        for n in [int(x) for x in args.request_sizes.split(",")]:
            rec = run_load(run_dir, n, args.clients,
                           args.requests_per_client, buckets,
                           args.max_wait_ms, args.device, args.quantize)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
