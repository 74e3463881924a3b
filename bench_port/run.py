#!/usr/bin/env python3
"""Run one cell of the benchmark of `bppp_tpu_torch` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for
(`BENCHMARK.json`). With `--trace 0` the run measures the cell's
end-to-end metrics over a window of `--seconds`; with `--trace 1` it
profiles a fixed number of whole batches and reports the per-layer
metrics. Either way it checks what the timed path produced against the
plain reference (`bench_port/reference/`), prints each number compared
beside its limit on standard error, and prints one JSON line last on
standard output. Without CUDA, or with fewer cards than the cell asks
for, it exits non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_port.harness import registry, runner

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]

    import torch

    runner.few_threads()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=_T0, bench=bench)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
