"""The port imports neither JAX nor the JAX package, nor TensorFlow or
protobuf (the frozen Inception graph is read and written without them): an
AST scan of every module of graphical_gan_tpu_torch and of chip_smoke.py,
and a subprocess that imports every port module and then finds none of
them in ``sys.modules``.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "graphical_gan_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "graphical_gan_tpu", "tensorflow", "google")
# in sys.modules: protobuf by its package (other google.* namespace
# packages load with torch)
FORBIDDEN_MODULES = FORBIDDEN[:-1] + ("google.protobuf",)


def _port_files():
    """chip_smoke.py and the package's modules; ``_build/`` holds build
    outputs (and whatever else a run leaves there), not the package."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "_build")
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import graphical_gan_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if any(m == f or "
        f"m.startswith(f + '.') for f in {FORBIDDEN_MODULES!r}))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


PARALLEL_MODULES = ["parallel/__init__.py", "parallel/mesh.py",
                    "parallel/context.py",
                    "parallel/collectives.py", "parallel/input.py",
                    "parallel/sharding_rules.py", "parallel/sequence.py",
                    "parallel/expert.py", "parallel/composed.py",
                    "core/shard_ctx.py", "parallel/pipeline.py",
                    "train/checkpoint_orbax.py", "serve/server.py",
                    "data/common.py"]


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_parallel_modules_are_scanned_and_import_no_jax(rel):
    path = os.path.join(PKG, rel)
    assert path in _port_files()
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("n,parallel,shape,size", [
    (2, "dp", None, 2), (None, "tp", "1,2", 2), (4, "ep", None, 4),
    (None, "composed", "data=2,model=2", 4)])
def test_mesh_outside_a_process_group_raises_with_torchrun_line(
        n, parallel, shape, size, monkeypatch):
    """``--n-devices N`` (or a ``--mesh-shape`` of N ranks) in a process
    that is no rank of a group of N: an error that says how to launch it,
    never a run on one device."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.runs.gan_inference import maybe_mesh
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"torchrun --nproc-per-node "
                                           f"{size}"):
        maybe_mesh(n, parallel, shape, "cpu")


def test_cli_n_devices_outside_torchrun_exits_with_the_line():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    res = subprocess.run(
        [sys.executable, "-m", "graphical_gan_tpu_torch.runs.gan_inference",
         "--n-devices", "2", "--device", "cpu", "--iters", "1", "--dim",
         "8", "--outdir", os.devnull], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "torchrun --nproc-per-node 2" in res.stderr
    assert "iter 0" not in res.stdout


def test_pp_is_refused_for_a_later_slice(monkeypatch):
    """pp is offered now (``parallel/pipeline.py``): ``--parallel pp``
    alone asks for the 2-stage mesh and ``--mesh-shape 4`` the 4-stage
    one, and outside a process group of that many ranks each raises with
    the torchrun line, as the other strategies do."""
    import torch.distributed as dist
    from graphical_gan_tpu_torch.runs.gan_inference import maybe_mesh
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    for shape, size in ((None, 2), ("4", 4)):
        with pytest.raises(RuntimeError,
                           match=f"torchrun --nproc-per-node {size}"):
            maybe_mesh(None, "pp", shape, "cpu")
