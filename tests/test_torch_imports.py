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


# -- what chip_smoke.py compares and reports -------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B", [5, 64, 70, 131, 203, 1024, 17 * 1024, 32 * 1024])
def test_chip_smoke_compares_lanes_from_both_ends_of_a_launch(B):
    """The lanes a slow plain version runs on reach the last lane, so the
    partial tail block of a ragged batch is compared too, and keep lanes
    0..4, where the checks put their special values."""
    cs = _chip_smoke()
    lanes = cs.plain_lanes(B, "cpu").tolist()
    assert len(lanes) == min(B, cs.PLAIN_B) and len(set(lanes)) == len(lanes)
    assert lanes[: min(B, 5)] == list(range(min(B, 5))) and lanes[-1] == B - 1
    assert all(0 <= i < B for i in lanes)
    if B > cs.PLAIN_B:
        assert (B - 1) // 64 == lanes[-1] // 64 and lanes[-32] == B - 32


@pytest.mark.parametrize("name", ["f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add",
                                  "pt_double", "scalar_mul", "tree_sum"])
def test_chip_smoke_names_each_kernel_its_source_and_what_it_replaces(name):
    cs = _chip_smoke()
    source, replaces = cs.REPLACES[name]
    with open(os.path.join(ROOT, source)) as fh:
        text = fh.read()
    assert "__global__" in text and f"bppp_{name}" in text
    path, line = replaces.split(":")
    with open(os.path.join(ROOT, path)) as fh:
        lines = fh.readlines()
    assert "pl.pallas_call(" in lines[int(line) - 1], lines[int(line) - 1]
    assert name in cs.MAIN_ROW and any(name in ks for ks in cs.PATH_KERNELS.values())
    assert any(name in mod.LAUNCHES and name in mod.PLAIN_CALLS for mod in cs.COUNTERS)


def test_chip_smoke_holds_every_small_msm_point_count_against_the_plain_version():
    """K4 is compiled once per point count D; the paths reach D = 1, 2, 4
    and 5. The kernels phase runs all of 1..DMAX."""
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.phase_kernels)
    assert "for D in range(1, cuda_msm.DMAX + 1)" in src
    assert "check_msm_small(gen, dev, BATCH, D)" in src
