"""The port's installed entry points and package data (``pyproject.toml``):
each ``ggan-torch-*`` console script is a ``ggan-*`` script of the JAX
package at the port's module of the same path, and the reverse; each
module imports without JAX or the JAX package and has a callable ``main``;
every CUDA source of ``graphical_gan_tpu_torch/csrc/`` matches the
package-data globs, so an installed port builds its kernels as a checkout
does (``ops/kernels/build.py: CSRC``).
"""

import fnmatch
import json
import os
import subprocess
import sys
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "pyproject.toml"), "rb") as _f:
    PROJECT = tomllib.load(_f)
SCRIPTS = PROJECT["project"]["scripts"]
PORT = sorted(n for n in SCRIPTS if n.startswith("ggan-torch-"))


def _jax_name(name: str) -> str:
    return name.replace("ggan-torch-", "ggan-", 1)


def test_every_jax_script_has_a_port_script_and_the_reverse():
    jax_scripts = {n for n in SCRIPTS if not n.startswith("ggan-torch-")}
    assert {_jax_name(n) for n in PORT} == jax_scripts
    assert len(PORT) == 14


@pytest.mark.parametrize("name", PORT)
def test_the_port_script_is_the_jax_scripts_module_path(name):
    assert SCRIPTS[name] == SCRIPTS[_jax_name(name)].replace(
        "graphical_gan_tpu.", "graphical_gan_tpu_torch.", 1)


@pytest.fixture(scope="module")
def imported():
    """{script: whether its module's ``main`` is callable}, from one process
    in which importing jax or the JAX package raises."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = sys.modules['graphical_gan_tpu'] = None\n"
        f"targets = {json.dumps({n: SCRIPTS[n] for n in PORT})}\n"
        "out = {}\n"
        "for name, target in targets.items():\n"
        "    module, attr = target.split(':')\n"
        "    out[name] = callable(getattr(importlib.import_module(module),"
        " attr, None))\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", PORT)
def test_the_port_script_imports_without_jax(name, imported):
    assert imported[name] is True


def test_the_cuda_sources_are_package_data():
    globs = PROJECT["tool"]["setuptools"]["package-data"][
        "graphical_gan_tpu_torch"]
    csrc = os.path.join(ROOT, "graphical_gan_tpu_torch", "csrc")
    files = sorted(os.listdir(csrc))
    assert any(f.endswith(".cu") for f in files)
    assert any(f.endswith(".cuh") for f in files)
    for f in files:
        assert any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs), f
    # the package itself is found
    assert any(fnmatch.fnmatch("graphical_gan_tpu_torch", p) for p in
               PROJECT["tool"]["setuptools"]["packages"]["find"]["include"])


def test_the_torch_extra_names_torch():
    assert PROJECT["project"]["optional-dependencies"]["torch"] == ["torch"]
