"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is built at first use
into ``graphical_gan_tpu_torch/_build/`` (listed in ``.gitignore``), or into
the directory ``core/compile_cache.py: enable_compile_cache`` names, under a
name that hashes the sources and flags and then ``nvcc --version``'s output,
so an edited source or another toolkit rebuilds and an unchanged one loads
the library already there. ``nvcc --version`` is run once per toolkit
binary: its output is kept in the build directory under a name that hashes
the binary's path, size and time, so a second process loads the library
with no ``nvcc`` run; a machine without ``nvcc`` loads the newest library
built from these sources and flags. A library is published atomically (built
under a temporary name, then ``os.replace``), so processes that build into
one directory at once never load a half-written file. A failed build
raises, and so does a library that fails to load (it is not rebuilt).

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
    # x, scales, scalar, C, inner, q, dtype, n, vec, stream
    "ggan_quantize_int8": [_P, _P, ctypes.c_float, _I, ctypes.c_longlong, _P,
                           _I, ctypes.c_longlong, _I, _P],
    # x, wk, factor, bias, y, out, act, leak, B, H, W, Cin, KH, KW, Cout,
    # n_rows, OH, OW, stride, pad_h, pad_w, avec, wvec, stream
    "ggan_int8_conv": [_P] * 5 + [_I] * 2 + [ctypes.c_float] + [_I] * 15
    + [_P],
    # x, wk, factor, bias, y, ws, out, act, leak, B, H, W, Cin, KH, KW,
    # Cout, n_rows, OH, OW, stride, pad_h, pad_h_hi, pad_w, pad_w_hi, dense,
    # bm, bn, bk, stages, splits, per, stream
    "ggan_int8_conv_tma": [_P] * 6 + [_I] * 2 + [ctypes.c_float] + [_I] * 22
    + [_P],
    # x, mean, inv, scale, offset, y, q, qs, dtype, numel, C, act, vec,
    # stream
    "ggan_bn_apply_q8": [_P] * 7 + [ctypes.c_float, _I, ctypes.c_longlong,
                                    _I, _I, _I, _P],
    # x, out, dtype, R, C, vec, tx, rows, cluster, smem, index, W, stream
    "ggan_bn_stats_local": [_P] * 2 + [_I] * 7 + [ctypes.c_longlong, _I, _I,
                                                  _P],
    # x, parts, scale, offset, y, stats, q, qs, dtype, R, C, W, vec, tx,
    # rows, n_rr, smem, eps, act, stream
    "ggan_bn_apply_split": [_P] * 7 + [ctypes.c_float] + [_I] * 8
    + [ctypes.c_longlong, ctypes.c_float, _I, _P],
    # g, x, mean, inv, scale, offset, out, dtype, R, C, vec, tx, rows,
    # cluster, smem, act, index, W, stream
    "ggan_bn_bwd_local": [_P] * 7 + [_I] * 7 + [ctypes.c_longlong, _I, _I,
                                                _I, _P],
    # g, x, mean, inv, scale, offset, sums, dx, dtype, R, C, W, vec, tx,
    # rows, n_rr, smem, n_rows, act, stream
    "ggan_bn_bwd_apply_split": [_P] * 8 + [_I] * 8
    + [ctypes.c_longlong, ctypes.c_float, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None
# where the library is built and looked up; enable_compile_cache sets it
_cache_dir: Optional[str] = None
build_log = ""


def build_dir() -> str:
    """The directory the library is built into and loaded from."""
    return _cache_dir or BUILD_DIR


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else None


def nvcc_path() -> str:
    found = find_nvcc()
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ with the CUDA toolkit at first "
                           "use")
    return found


def _write_atomic(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def nvcc_version(nvcc: str, directory: str) -> str:
    """``nvcc --version``'s output, run once per toolkit binary (its real
    path, size and modification time) and kept in ``directory``."""
    real = os.path.realpath(nvcc)
    st = os.stat(real)
    stamp = hashlib.sha256(f"{real}:{st.st_size}:{st.st_mtime_ns}"
                           .encode()).hexdigest()[:16]
    memo = os.path.join(directory, f"nvcc-{stamp}.version")
    if os.path.exists(memo):
        with open(memo) as f:
            return f.read()
    out = subprocess.run([nvcc, "--version"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, check=True
                         ).stdout
    _write_atomic(memo, out)
    return out


def library_name(version: str) -> str:
    """The library's file name: the sources and flags' digest, then the
    toolkit's (from ``nvcc --version``)."""
    tool = hashlib.sha256(version.encode()).hexdigest()[:12]
    return f"libggan_kernels_{_digest()}_{tool}.so"


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the shared library in :func:`build_dir`
    unless it is there; returns its path."""
    global build_log
    directory = build_dir()
    os.makedirs(directory, exist_ok=True)
    nvcc = find_nvcc()
    if nvcc is None and not force:
        built = glob.glob(os.path.join(directory,
                                       f"libggan_kernels_{_digest()}_*.so"))
        if built:
            return max(built, key=os.path.getmtime)
    nvcc = nvcc_path()
    out = os.path.join(directory, library_name(nvcc_version(nvcc,
                                                            directory)))
    if os.path.exists(out) and not force:
        return out
    with tempfile.TemporaryDirectory(dir=directory) as tmp:
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
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build()
            try:
                handle = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"the kernel library {path} does not "
                                   f"load ({e}); delete it to rebuild"
                                   ) from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _lib_path = handle, path
        return _lib


def loaded_path() -> Optional[str]:
    """The path of the loaded library, or None before :func:`lib`."""
    return _lib_path


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def run_op(op, cuda_impl, x, *args):
    """A kernel wrapper's call on CUDA: through its ``torch.library`` op
    ``op`` where ``torch.export`` or ``torch.compile`` traces it (``x`` is
    then a fake or functional tensor), so the program records the op;
    straight to the op's CUDA implementation ``cuda_impl`` in eager mode,
    where the dispatcher costs the host 5-46 µs a call, 3.9 ms of a
    published cifar10 wali-gp f32 iteration (the H100 machine's host;
    PERF.md §6). Both run the same function, which counts the launch."""
    import torch
    if type(x) is torch.Tensor and not torch.compiler.is_compiling():
        return cuda_impl(x, *args)
    return op(x, *args)
