"""The kernel build cache (``graphical_gan_tpu_torch/core/
compile_cache.py``, ``ops/kernels/build.py``; JAX
``tests/test_compile_cache.py``): ``enable_compile_cache`` makes a
directory the place where the CUDA library is built and looked up. Its
semantics (flag, env, off), a build into an empty cache with ``nvcc``
replaced by a stub that writes files, a second process that loads from the
cache without calling the stub, a cached library that does not load
raises and is not rebuilt, the key covers the toolkit, enabling after a
load publishes the loaded library, and the CLIs and the server forward
``--compile-cache``. Runs without a card.
"""

import os
import subprocess
import sys

import pytest

from graphical_gan_tpu_torch.core import compile_cache
from graphical_gan_tpu_torch.core.compile_cache import enable_compile_cache
from graphical_gan_tpu_torch.ops.kernels import build
from _torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if "--version" in sys.argv:
    print("stub nvcc: Cuda compilation tools, release 12.8")
elif "-o" in sys.argv:
    with open(sys.argv[sys.argv.index("-o") + 1], "w") as f:
        f.write("not a library")
"""


@pytest.fixture
def restore_build_state(monkeypatch):
    """Snapshot and restore the build module's directory and library."""
    for name in ("_cache_dir", "_lib", "_lib_path"):
        monkeypatch.setattr(build, name, getattr(build, name))
    yield


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` first on PATH that logs its calls and writes its -o."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    log.write_text("")
    stub = bindir / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return log


def test_disabled_without_flag_or_env(restore_build_state, monkeypatch):
    monkeypatch.delenv("GGAN_COMPILE_CACHE", raising=False)
    before = build.build_dir()
    assert enable_compile_cache(None) is None
    assert build.build_dir() == before == build.BUILD_DIR


def test_flag_wins_over_env(restore_build_state, tmp_path, monkeypatch):
    monkeypatch.setenv("GGAN_COMPILE_CACHE", str(tmp_path / "env"))
    got = enable_compile_cache(str(tmp_path / "flag"))
    assert got == str(tmp_path / "flag")
    assert os.path.isdir(got)
    assert build.build_dir() == got


def test_env_fallback(restore_build_state, tmp_path, monkeypatch):
    monkeypatch.setenv("GGAN_COMPILE_CACHE", str(tmp_path / "env"))
    got = enable_compile_cache(None)
    assert got == str(tmp_path / "env") and os.path.isdir(got)


def test_build_writes_then_a_second_process_loads_without_nvcc(
        restore_build_state, stub_nvcc, tmp_path):
    cache = enable_compile_cache(str(tmp_path / "cc"))
    path = build.build()
    assert os.path.dirname(path) == cache and os.path.isfile(path)
    calls = stub_nvcc.read_text().splitlines()
    assert calls[0] == "--version"
    assert sum("-c " in c for c in calls) == len(build.sources())
    assert sum("-shared" in c for c in calls) == 1
    entries = sorted(os.listdir(cache))
    assert not [e for e in entries if e.endswith(".tmp")]

    # another process pointing at the cache: the same library, no nvcc call
    code = ("from graphical_gan_tpu_torch.core.compile_cache import "
            "enable_compile_cache\nfrom graphical_gan_tpu_torch.ops.kernels "
            "import build\nenable_compile_cache()\nprint(build.build())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(
        os.environ, GGAN_COMPILE_CACHE=cache, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == path
    assert stub_nvcc.read_text().splitlines() == calls
    assert sorted(os.listdir(cache)) == entries

    # the stub's file is no library: loading raises, and nothing rebuilds
    with pytest.raises(RuntimeError, match="does not load"):
        build.lib()
    assert stub_nvcc.read_text().splitlines() == calls


def test_the_key_covers_the_toolkit_and_the_sources(restore_build_state,
                                                    monkeypatch):
    a = build.library_name("Cuda compilation tools, release 12.8")
    assert a != build.library_name("Cuda compilation tools, release 12.9")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_name("Cuda compilation tools, release 12.8") != a


def test_enabling_after_a_load_publishes_the_library(restore_build_state,
                                                     tmp_path, monkeypatch):
    other = tmp_path / "other"
    other.mkdir()
    loaded = other / build.library_name("v")
    loaded.write_bytes(b"\x7fELF stand-in")
    monkeypatch.setattr(build, "_lib_path", str(loaded))
    cache = enable_compile_cache(str(tmp_path / "cc"))
    published = os.path.join(cache, loaded.name)
    with open(published, "rb") as f:
        assert f.read() == loaded.read_bytes()
    # a machine without nvcc loads the newest library of these sources
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    assert build.build() == published


def test_cli_mains_forward_compile_cache(monkeypatch):
    """--compile-cache (and the other failure flags) reach run() for all
    three entry points."""
    import graphical_gan_tpu_torch.runs.gan_inference as gi
    import graphical_gan_tpu_torch.runs.gmgan as gm
    import graphical_gan_tpu_torch.runs.ssgan as ss

    calls = {}

    def fake(which):
        def run(dataset, mode, **kw):
            calls[which] = kw
        return run

    monkeypatch.setattr(gi, "run", fake("gi"))
    monkeypatch.setattr(gm, "run", fake("gm"))
    monkeypatch.setattr(ss, "run", fake("ss"))

    gi.main(["--dataset", "cifar10", "--compile-cache", "/tmp/cc1",
             "--max-rollbacks", "2", "--checkpoint-backend", "npz"])
    assert calls["gi"]["compile_cache"] == "/tmp/cc1"
    assert calls["gi"]["max_rollbacks"] == 2
    assert calls["gi"]["checkpoint_backend"] == "npz"
    gm.main(["--dataset", "mnist", "--compile-cache", "/tmp/cc2"])
    assert calls["gm"]["compile_cache"] == "/tmp/cc2"
    ss.main(["--dataset", "moving_mnist", "--compile-cache", "/tmp/cc3"])
    assert calls["ss"]["compile_cache"] == "/tmp/cc3"
    # the default stays off
    gi.main(["--dataset", "cifar10"])
    assert calls["gi"]["compile_cache"] is None
    assert calls["gi"]["max_rollbacks"] == 0
    # the sharded backend is offered by all three (checkpoint_orbax.py)
    gi.main(["--checkpoint-backend", "orbax"])
    assert calls["gi"]["checkpoint_backend"] == "orbax"
    gm.main(["--checkpoint-backend", "orbax"])
    assert calls["gm"]["checkpoint_backend"] == "orbax"
    ss.main(["--checkpoint-backend", "orbax"])
    assert calls["ss"]["checkpoint_backend"] == "orbax"
    with pytest.raises(SystemExit):
        gi.main(["--checkpoint-backend", "tensorstore"])


def test_serve_cli_forwards_compile_cache(monkeypatch):
    """The server enables the cache before it builds its entry."""
    import graphical_gan_tpu_torch.serve.server as srv

    seen = {}
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda d=None: seen.setdefault("dir", d))
    monkeypatch.setattr(
        srv, "serve_run_dir",
        lambda *a, **k: (_ for _ in ()).throw(SystemExit(0)))
    with pytest.raises(SystemExit):
        srv.main(["--run-dir", "/nonexistent", "--compile-cache",
                  "/tmp/cc4"])
    assert seen["dir"] == "/tmp/cc4"
