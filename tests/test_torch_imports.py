"""The port stands alone: no module of bppp_tpu_torch, nor chip_smoke.py,
imports jax or anything of bppp_tpu, and importing the package pulls in
neither."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "bppp_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "bppp_tpu_torch")):
        if "_build" in base.split(os.sep):
            continue
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_module_imports_no_jax_and_nothing_of_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {name}"


def test_every_port_module_is_walked():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for must in ("chip_smoke.py", "bppp_tpu_torch/ops/field.py", "bppp_tpu_torch/ops/_build.py",
                 "bppp_tpu_torch/protocol/u64.py", "bppp_tpu_torch/oracle/merlin.py"):
        assert must in rel


def test_importing_the_port_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, pkgutil, importlib, bppp_tpu_torch\n"
        "for m in pkgutil.walk_packages(bppp_tpu_torch.__path__, 'bppp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bppp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
