"""The kernel build cache (``graphical_gan_tpu/core/compile_cache.py``'s
counterpart).

JAX keeps compiled XLA executables on disk so that a restarted run does not
compile its step again. The port's compile step is ``nvcc``: the CUDA
kernels of ``csrc/`` are built into one shared library at first use
(``ops/kernels/build.py``). :func:`enable_compile_cache` makes a directory
the place where that library is built and looked up, in place of
``graphical_gan_tpu_torch/_build/``, so a fresh checkout, container or
replica that points at a shared directory loads the library with no
``nvcc`` run. Every entry point takes it:

- CLI: ``--compile-cache DIR`` on ``runs/gan_inference.py``,
  ``runs/gmgan.py``, ``runs/ssgan.py`` (and the ten aliases) and
  ``serve/server.py``;
- env: ``GGAN_COMPILE_CACHE=DIR``; the flag wins where both are set.

The library's name hashes the sources, ``NVCC_FLAGS`` and ``nvcc
--version``'s output, so one directory can hold the builds of several
source trees and toolkits, and an entry is never stale. Publishing is
atomic (a temporary name, then ``os.replace``): processes that build into
one directory at once never load a half-written file.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

from graphical_gan_tpu_torch.ops.kernels import build

__all__ = ["enable_compile_cache"]


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Build and load the kernel library in ``cache_dir`` (else
    ``GGAN_COMPILE_CACHE``); with neither, a no-op that returns None.
    Returns the absolute directory. If the library is already loaded from
    another directory, that file is published into this one under its
    name, so later processes find it there."""
    cache_dir = cache_dir or os.environ.get("GGAN_COMPILE_CACHE")
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    loaded = build.loaded_path()
    if loaded is not None and os.path.dirname(loaded) != cache_dir:
        target = os.path.join(cache_dir, os.path.basename(loaded))
        if not os.path.exists(target):
            fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
            os.close(fd)
            shutil.copyfile(loaded, tmp)
            os.replace(tmp, target)
    build._cache_dir = cache_dir
    return cache_dir
