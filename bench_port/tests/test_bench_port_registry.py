"""Every piece of a cell is found by name; a new one is picked up
without editing a file that exists."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port.harness import registry

from .conftest import ROOT


def test_everything_benchmark_json_names_is_found():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert registry.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert hasattr(registry.driver(wl["driver"]), "Driver")
        assert registry.end_to_end_of(bench, w["name"])
        assert registry.per_layer_of(bench, w["name"])
        assert any(m["name"] == "setup_s" for m in registry.end_to_end_of(bench, w["name"]))
    for m in bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)
        for cell in m.get("workloads", []):
            moves = {e["name"] for e in registry.end_to_end_of(bench, cell)}
            assert m["moves"] in moves, (m["name"], cell)


def test_readers_find_nothing_in_another_kind_of_run():
    bench = registry.benchmark()
    trace = dict(launches_per_batch=10.0, eager_s_per_batch=0.1, hand_written_s_per_batch=0.01,
                 busy_s=0.5, window_s=1.0)
    for m in bench["per_layer"]:
        name = m["name"]
        if "." not in name:
            continue
        kind = name.rsplit(".", 1)[1]
        reader = registry.metric(name).read
        assert reader({"kind": "other", "trace": trace, "bound_s_per_batch": 0.001}) is None
        assert reader({"kind": kind, "trace": trace, "bound_s_per_batch": 0.001}) is not None
        # a trace with no device time gives no idle share and no roofline
        empty = dict(trace, busy_s=0.0, hand_written_s_per_batch=0.0)
        if name.startswith(("device_idle_share", "hand_written_roofline")):
            assert reader({"kind": kind, "trace": empty, "bound_s_per_batch": 0.0}) is None


def test_a_new_cell_file_is_picked_up(tmp_path, monkeypatch):
    here = tmp_path / "bench_port"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((here / "workloads" / "u64.verify_fast.b16384.json").read_text())
    wl["batch"] = 4096
    (here / "workloads" / "u64.verify_fast.b4096.json").write_text(json.dumps(wl))
    (here / "metrics" / "new_metric.verify.py").write_text("def read(m):\n    return 1.5\n")
    bench = registry.benchmark()
    bench["workloads"].append({"name": "u64.verify_fast.b4096", "config": "u64",
                               "traffic": "verify_fast.b4096", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric.verify", "unit": "x", "better": "lower",
                               "source": "host_clock", "layer": "test", "moves": "verifies_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "verifies_per_s":
            m["workloads"].append("u64.verify_fast.b4096")
    monkeypatch.setattr(registry, "HERE", str(here))
    for k in [k for k in sys.modules if k.startswith(("bench_port.metrics.", "bench_port.drivers."))]:
        monkeypatch.delitem(sys.modules, k)
    assert registry.workload("u64.verify_fast.b4096")["batch"] == 4096
    names = {m["name"] for m in registry.per_layer_of(bench, "u64.verify_fast.b4096")}
    assert "new_metric.verify" in names
    assert registry.metric("new_metric.verify").read({}) == 1.5
    assert "verifies_per_s" in {m["name"] for m in registry.end_to_end_of(bench, "u64.verify_fast.b4096")}


def test_run_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "u64.verify_fast.b16384",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(registry.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "u64.verify_fast.b16384",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "u64.verify_fast.b16384",
                        "--seed", str(2**33 + 9), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["metrics"]["verifies_per_s"]["value"] > 0
