"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is built at first use
into ``graphical_gan_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already there. A failed build raises.

The C entry points take every pointer, and the CUDA stream, as ``c_void_p``
and return ``cudaGetLastError()`` after their launch; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# dtype and activation codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
ACT_CODES = {None: 0, "relu": 1, "leaky_relu": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, bias, y, ws, dtype, B, H, W, Cin, KH, KW, Cout, OH, OW, stride,
    # pad_h, pad_w, act, leak, path, bm, bn, bk, stages, vec, splits, per,
    # stream
    "ggan_conv2d_bias_act": [_P] * 5 + [_I] * 14 + [ctypes.c_float]
    + [_I] * 8 + [_P],
    # x, part, out, dtype, R, C, vec, tx, rows, n_rb, smem, grid, eps,
    # stream
    "ggan_bn_stats": [_P] * 3 + [_I] * 7 + [ctypes.c_longlong, _I,
                                            ctypes.c_float, _P],
    # x, mean, inv, scale, offset, y, dtype, numel, C, act, vec, stream
    "ggan_bn_apply": [_P] * 6 + [_I, ctypes.c_longlong, _I, _I, _I, _P],
    # g, x, mean, inv, scale, offset, part, red, dx, dtype, R, C, vec, tx,
    # rows, n_rb, slots, cache_rows, smem, grid, act, stream
    "ggan_bn_bwd": [_P] * 9 + [_I] * 9 + [ctypes.c_longlong, _I, _I, _P],
    # x, w, bias, y, ws, geo (int64[25]), B, H, W, Cin, K, Cout, OH, OW,
    # stride, pad_h, pad_w, act, leak, bm, bn, splits, per, stream
    "ggan_conv_gemm_tma": [_P] * 6 + [_I] * 12 + [ctypes.c_float]
    + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit at first use")


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the shared library; returns its path."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libggan_kernels_{_digest()}.so")
    if os.path.exists(out) and not force:
        return out
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for cmd, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(cmd)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                *[obj for _, obj, _ in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
