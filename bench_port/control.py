#!/usr/bin/env python3
"""The readings that set a cell's limits, in one process: the program on
several seeds, the control, and faults planted under the timed path.

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 --seconds 3 \\
        --runs none control altered half_batch unchanged

`none` is the program as the benchmark runs it; `control` is the program
with one guarantee of the configuration broken (a verifier that skips its
final check; a u64 prover given its neighbour lane's draws; a WNLA prover
given mu = rho); the others are `harness/faults.py`. Every run prints one
JSON line with its checks and `correct`. The benchmark's own runs
(`run.py`) run none of these. Needs the card, as `run.py` does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--runs", nargs="+", default=["none", "control"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_port.harness import runner

    import torch

    runner.few_threads()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for kind in args.runs:
            t0 = time.perf_counter()
            try:
                out = runner.run(args.workload, seed, args.seconds, False, device=args.device,
                                 fault=None if kind in ("none", "control") else kind,
                                 control=kind == "control")
                line = {"run": kind, "seed": seed, "correct": out["correct"], "checks": out["checks"],
                        "attempted": out["attempted"], "failed": out["failed"],
                        "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
            except Exception as e:  # a run that crashes gives no number: it has failed
                line = {"run": kind, "seed": seed, "correct": False, "error": repr(e)[:500]}
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
