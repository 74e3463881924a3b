#!/usr/bin/env python3
"""Find the highest arrival rate an open-loop cell sustains: one set-up,
then the cell's open loop at each rate given, one after the other.

    python3 bench_port/tools/sweep.py --workload u64.verify_stream.p80 --seed 5 \\
        --rates 12000 16000 20000 --seconds 15

For each rate one JSON line: the proofs answered per second, the latency
quantiles, how long the last proofs waited for the card against the first
(a backlog that grows shows as a queue that grows through the run), and
whether every verdict was the reference's. Needs the card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from bench_port.harness import program, registry, runner

    runner.few_threads()
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    ctx = runner.Context(args.workload, args.seed, "cuda", registry.benchmark())
    drv = registry.driver(ctx.workload["driver"]).Driver(ctx)
    torch.zeros(1, device="cuda")
    drv.make_inputs()
    program.load_kernels()
    drv.setup()
    drv.warm()
    want = drv.expected()
    for rate in args.rates:
        t0 = time.perf_counter()
        win = drv.open_loop(rate, args.seconds, f"sweep {rate}")
        lat, q, arr = win["latency_ms"], win["queue_ms"], win["arrivals"]
        v = win["outs"][0]["verdicts"]
        wrong = int((v != want[np.arange(len(v)) % drv.B]).sum())
        fifth = max(1, len(q) // 5)
        print(json.dumps({
            "rate_per_s": rate, "proofs": len(arr), "answered_per_s": len(arr) / win["seconds"],
            "served_s": win["seconds"], "p50_ms": float(np.quantile(lat, 0.5)),
            "p95_ms": float(np.quantile(lat, 0.95)), "p99_ms": float(np.quantile(lat, 0.99)),
            "queue_first_fifth_ms": float(q[:fifth].mean()), "queue_last_fifth_ms": float(q[-fifth:].mean()),
            "batches": len(win["batches"]), "mean_batch": float(np.mean([k for k, _ in win["batches"]])),
            "sizes": sorted({s for _, s in win["batches"]}), "wrong_verdicts": wrong,
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
