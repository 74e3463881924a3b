"""Nothing the benchmark runs imports the JAX side; the reference imports
nothing of the program."""

import ast
import os

import pytest

from .conftest import ROOT

HERE = os.path.join(ROOT, "bench_port")
FORBIDDEN = {"jax", "jaxlib", "flax", "bppp_tpu"}


def _files(sub=""):
    out = []
    for d, _, fs in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(out)


def _top_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_of_the_benchmark_imports_the_jax_side(path):
    assert not (_top_names(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_only_the_standard_library(path):
    import sys

    allowed = set(sys.stdlib_module_names) | {"__future__"}
    assert _top_names(path) <= allowed, path


def test_the_port_loads_no_jax_module():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port.harness import registry, runner, program\n"
            "for c in registry.benchmark()['workloads']:\n"
            "    registry.driver(registry.workload(c['name'])['driver'])\n"
            "import bppp_tpu_torch.models, bppp_tpu_torch.protocol.convert\n"
            "print(runner.forbidden_modules())\n") % ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
