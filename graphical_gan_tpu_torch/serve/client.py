"""Stdlib HTTP client for ``serve/server.py`` (a copy of
``graphical_gan_tpu/serve/client.py``: the HTTP surface is the same).

Dependency-free (urllib + numpy), so a serving fleet's callers need neither
this package nor PyTorch.
"""

from __future__ import annotations

import io
import json
import urllib.request
from typing import Optional, Sequence

import numpy as np


class SamplerClient:
    def __init__(self, base_url: str, timeout: float = 180.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path,
                                    timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    def healthz(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")

    def sample(self, n: Optional[int] = None, seed: int = 0,
               inputs: Optional[Sequence[np.ndarray]] = None,
               exact: bool = False) -> np.ndarray:
        """Request ``n`` prior-seeded samples, or samples for explicit
        ``inputs`` (arrays in manifest order).  Returns the image array."""
        if inputs is not None:
            buf = io.BytesIO()
            np.savez(buf, **{f"input{i}": np.asarray(a, np.float32)
                             for i, a in enumerate(inputs)})
            body = buf.getvalue()
            req = urllib.request.Request(
                self.base + "/sample", data=body, method="POST",
                headers={"Content-Type": "application/octet-stream",
                         "X-GGAN-Seed": str(int(seed)),
                         **({"X-GGAN-Exact": "1"} if exact else {})})
        else:
            if n is None:
                raise ValueError("pass n or inputs")
            body = json.dumps({"n": int(n), "seed": int(seed),
                               "exact": bool(exact)}).encode()
            req = urllib.request.Request(
                self.base + "/sample", data=body, method="POST",
                headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            meta = json.loads(r.headers.get("X-GGAN-Meta", "{}"))
            data = np.load(io.BytesIO(r.read()))
            # servers key the array by the entry's output name ('latents',
            # 'probs', ...); 'images' is kept as a compatibility alias
            name = meta.get("output", "images")
            return data[name if name in data else "images"]
