"""Everything a cell is made of, found by name.

`BENCHMARK.json` (at the root of the checkout) names the cells, the
configurations and the metrics. Each piece sits in a file of its own under
`bench_port/`: a configuration in `configs/<config>.json`, a cell's traffic
in `workloads/<cell>.json`, the entry point a cell drives in
`drivers/<driver>.py` (named by its workload file), a per-layer metric's
reader in `metrics/<metric>.py`. Adding a cell, a configuration or a
metric adds files and entries; no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_port/
ROOT = os.path.dirname(HERE)  # the checkout


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", f"{name}.json"))


def _module(kind: str, name: str):
    """bench_port/<kind>/<name>.py as a module (a name may hold dots)."""
    mod_name = f"bench_port.{kind}.{name.replace('.', '__')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module("drivers", name)


def metric(name: str):
    return _module("metrics", name)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports: those without a `workloads`
    key, and those that list the cell."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a `workloads` key whose `moves` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
