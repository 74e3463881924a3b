#!/usr/bin/env python3
"""Run cells of the benchmark several times in a row, one process a run,
and summarise: each run's result line to a JSONL file, and per cell and
metric the median and the spread (distance between the quartiles of
`statistics.quantiles(values, n=4)` over the median).

    python3 bench_port/tools/repeat.py --workload <cell> [--workload ...] \\
        --seeds 11 12 13 --seconds 20 [--trace 1] --out runs.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spread(vals: list) -> float | None:
    if len(vals) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / q2 if q2 else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    summary = {}
    with open(args.out, "a") as fh:
        for cell in args.workload:
            for seed in args.seeds:
                cmd = [sys.executable, os.path.join(ROOT, "bench_port", "run.py"), "--workload", cell,
                       "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
                t0 = time.time()
                try:
                    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
                    rc, out, err = p.returncode, p.stdout, p.stderr
                except subprocess.TimeoutExpired as e:
                    rc, out, err = 124, e.stdout or "", e.stderr or ""
                    out = out.decode() if isinstance(out, bytes) else out
                    err = err.decode() if isinstance(err, bytes) else err
                lines = out.strip().splitlines()
                try:
                    res = json.loads(lines[-1]) if lines else None
                except json.JSONDecodeError:
                    res = None
                rec = {"cell": cell, "seed": seed, "trace": args.trace, "rc": rc,
                       "wall_s": time.time() - t0, "result": res,
                       "stderr_tail": err[-3000:] if (rc or res is None or not res.get("correct")) else err[-400:]}
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                metrics = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
                print(json.dumps({"cell": cell, "seed": seed, "rc": rc, "wall_s": round(rec["wall_s"], 1),
                                  "correct": None if res is None else res.get("correct"),
                                  "metrics": metrics,
                                  "checks": None if res is None else res.get("checks")}), flush=True)
                if res is None or rc:
                    print(err[-2000:], file=sys.stderr, flush=True)
                for k, v in metrics.items():
                    summary.setdefault(cell, {}).setdefault(k, []).append(v)
    for cell, ms in summary.items():
        for k, vals in ms.items():
            print(json.dumps({"summary": cell, "metric": k, "n": len(vals),
                              "median": statistics.median(vals), "spread": spread(vals),
                              "values": vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
