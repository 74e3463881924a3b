#!/usr/bin/env python3
"""Time the parts of a cell's set-up that only the program can shorten,
each on its own: the CUDA context, importing the port, loading its kernel
libraries, the fixtures' generators by Python EC multiplies, and the
fixed-base table builds (the first in a process and a second one).

    python3 bench_port/tools/setup_parts.py --seed 7

Prints one JSON line of seconds. Needs the card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    t0 = time.perf_counter()
    import torch

    out["import_torch"] = time.perf_counter() - t0
    if not torch.cuda.is_available():
        print("setup_parts: no CUDA device", file=sys.stderr)
        return 3
    timed("cuda_context", lambda: torch.zeros(1, device="cuda"))
    t0 = time.perf_counter()
    import bppp_tpu_torch.models  # noqa: F401
    from bppp_tpu_torch.models import u64_fixture
    from bppp_tpu_torch.ops import curve as dcv
    from bppp_tpu_torch.ops.fixed_base import build_tables
    from bppp_tpu_torch.protocol.u64 import build_u64_tables

    from bench_port.harness import program, traffic
    from bench_port.reference import instances

    out["import_port"] = time.perf_counter() - t0
    out["load_kernels"] = program.load_kernels()
    seed = traffic.seed_string("u64", args.seed)
    pub = timed("u64_generators_49_python_muls", lambda: instances.u64_public(seed))
    wseed = traffic.seed_string("wnla64", args.seed)
    g, gv, hv = timed("wnla_generators_129_python_muls", lambda: instances.wnla_generators(wseed, 64, 64))

    def u64_tables():
        return build_u64_tables(dcv.from_int_points([pub.g], squeeze=True, device="cuda"),
                                dcv.from_int_points(pub.g_vec, device="cuda"),
                                dcv.from_int_points(pub.h_vec, device="cuda"), 8)

    timed("u64_table_build_first", u64_tables)
    timed("u64_table_build_second", u64_tables)
    pts = dcv.from_int_points([g] + hv + gv, device="cuda")
    timed("wnla_table_build_129_first", lambda: build_tables(pts, 8))
    timed("wnla_table_build_129_second", lambda: build_tables(pts, 8))
    timed("u64_fixture_b16384", lambda: u64_fixture(seed, 16384, device="cuda", tables="auto"))
    timed("u64_fixture_b16384_again", lambda: u64_fixture(seed, 16384, device="cuda", tables="auto"))
    out["gpu"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
