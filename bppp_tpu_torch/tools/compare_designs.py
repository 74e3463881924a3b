#!/usr/bin/env python3
"""The kernels of this checkout that the port has redesigned — K3
(`fixed_msm`), K4 (`msm_small_wnaf`), K8 (`msm_small_glv`) and K9
(`msm_small`) — against those of an earlier checkout of the repo, in turns
inside one run.

    git archive <earlier commit> | tar -x -C <a git-ignored directory>
    python3 bppp_tpu_torch/tools/compare_designs.py --earlier <that directory>

Both packages are named `bppp_tpu_torch`, so each tree is measured in a
process of its own, four of them one after the other: earlier, this, this,
earlier. A process takes the package from its tree and the helpers from
this checkout's `chip_smoke.py`, and through the public wrappers only (so
any earlier tree with the same entry points will do):

  * measures a fresh u64 prove fixture at a batch of 1024: the peak device
    memory of its table build, the peak of its first commit + prove, what
    stays allocated after it, and the bytes its table subsets hold;
  * times `cuda_fixed_base.fixed_msm` over every table and row subset
    (`Tables.subset` / `take`) that a small u64 prove and the standalone
    WNLA at 16/32/64 walk, at 1024 lanes, and over the u64 table at 16384;
    `cuda_msm.msm_small_wnaf` at D = 1..5 on 1024 lanes, D = 2 and 5 on
    16384 and two ragged batches; `cuda_msm.msm_small_glv` and
    `cuda_msm.msm_small` at D = 1..3 on 1024 lanes, D = 3 on 16384, and
    the ragged D = 3 on 70 lanes and D = 2 on 77. Inputs come from one
    seed, so both trees get the same ones; each result is hashed as
    compressed points;
  * in this tree's processes, sweeps the kernels' launches through their C
    entry points: K3's slices per lane S, K4's threads per lane (2D or 1)
    across batch sizes, and K8's and K9's split (2D or D threads per lane,
    at 32, 64 and 128 threads per block) and K8's lane walk (one thread
    per lane) at D = 1..3 across the same batch sizes, each checked
    against the wrapper's result.

The script prints one JSON line: per row each tree's ms (the mean of its
two processes, CUDA events, median of 5 each) and whether all four
results agree; each tree's memory; the sweep; then the card's name and
power limit as `nvidia-smi` gives them. Exit code 1 if any result
disagrees. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K3_SWEEP = {1024: (8, 16, 32, 64), 16384: (1, 2, 4, 8, 16)}
K4_SWEEP_LANES = (1024, 2048, 4096, 8192, 16384)
U4_SWEEP_BLOCKS = (32, 64, 128)  # threads per block of K8's and K9's split
U4_KERNELS = ("msm_small_glv", "msm_small")


def load_chip_smoke(tree: str):
    """This checkout's chip_smoke.py over the package of `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def digest(cs, xyz) -> str:
    return hashlib.sha256(cs.dc.compress(cs.dc.PointJ(*xyz)).cpu().numpy().tobytes()).hexdigest()


def prove_memory(cs, dev) -> dict:
    """Device bytes of a fresh u64 prove fixture at a batch of 1024, above
    what was allocated before it."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, d, rng = cs.u64_fixture(cs.SEED, cs.BATCH, device=dev, tables="auto")
    pbt = cs.make_prove_batch(rng, dev)
    torch.cuda.synchronize()
    fixture_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    d.commit_value(pbt.x_words, pbt.s)
    d.prove(pbt.x_words, pbt.s, cs.Transcript(cs.LABEL, batch=(cs.BATCH,), device=dev), pbt.blind)
    torch.cuda.synchronize()
    subsets = list(d.tables["full"].subsets.values()) + [d.tables["gv"]]
    held = [t.words if getattr(t, "rows", None) is None else t.rows for t in subsets]
    out = dict(fixture_peak_bytes=fixture_peak,
               prove_peak_bytes=torch.cuda.max_memory_allocated() - base,
               resident_after_prove_bytes=torch.cuda.memory_allocated() - base,
               subset_bytes=sum(h.numel() * h.element_size() for h in held))
    del d, pbt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def k3_tables(cs, dev) -> list:
    """[(tables, tag, lanes)]: the u64 table at 1024 and 16384 lanes, its
    `gv` subset, then every table and subset a small u64 prove and the
    standalone WNLA provers walk, in the order they are first walked."""
    log = cs.new_shape_log()
    with cs.recording_shapes(log, "prove"):
        _, d, rng = cs.u64_fixture(cs.SEED, 4, device=dev, tables="auto")
        pbt = cs.u64_prove_batch(rng, [0, 1, 2, 3], 4, device=dev)
        d.prove(pbt.x_words, pbt.s, cs.Transcript(cs.LABEL, batch=(4,), device=dev), pbt.blind)
    for sz in cs.WNLA_SIZES:
        with cs.recording_shapes(log, f"wnla{sz}"):
            fx = cs.wnla_fixture(f"{cs.SEED} wnla {sz}", sz, sz, 2, device=dev, tables="auto")
            fx.dev.prove(fx.dev.commit(fx.l, fx.n),
                         cs.Transcript(fx.label, batch=(2,), device=dev), fx.l, fx.n)
    full, gv = d.tables["full"], d.tables["gv"]
    out = [(full, "F=49", cs.BATCH), (full, "F=49", cs.BIG_BATCH), (gv, "F=17 gv", cs.BATCH)]
    walked = [(t, w) for t, w in log["fixed_msm"].values() if t is not full and t is not gv]
    return out + [(t, f"F={t.n_points} {w} #{i}", cs.BATCH) for i, (t, w) in enumerate(walked)]


def k4_inputs(cs, gen, D, B, dev):
    coords = [c.movedim(1, 0).contiguous() for c in cs.rand_points(gen, (D, B), dev)]
    return coords, cs.glv.wnaf_planes(cs.rand_scalars(gen, (D, B), cs.N_INT, dev))


def fixed_msm_slices(cs, tab, sc, S):
    """This tree's K3 through its C entry point with S slices per lane."""
    F, B = sc.shape[1], sc.shape[2]
    flat = cs.cuda_curve.flat_i32(sc, sc.shape)
    outs = [torch.empty((16, B), dtype=torch.int32, device=sc.device) for _ in range(3)]
    part = torch.empty((S, 48, B), dtype=torch.int32, device=sc.device) if S > 1 else None
    vp = ctypes.c_void_p
    fn = cs._build.bind("fixed_msm", "bppp_fixed_msm", [vp] * 7 + [ctypes.c_int] * 5 + [vp])
    cs._build.check(fn(tab.words.data_ptr(), None if tab.rows is None else tab.rows.data_ptr(),
                       flat.data_ptr(), *(o.data_ptr() for o in outs),
                       None if part is None else part.data_ptr(),
                       F, tab.words.shape[1], B, tab.w_bits, S, cs._build.stream()), "fixed_msm")
    return tuple(o.to(torch.int64) for o in outs)


def msm_small_threads(cs, coords, dig, nthr):
    """This tree's K4 through its C entry point with nthr threads per lane
    (2D or 1)."""
    m = cs.cuda_msm
    D, _, B = coords[0].shape
    lpb = m.K4_LANE_BLOCK if nthr == 1 else m.K4_BLOCK // nthr
    ins = [cs.cuda_curve.flat_i32(t, t.shape) for t in (*coords, dig)]
    outs = [torch.empty((16, B), dtype=torch.int32, device=dig.device) for _ in range(3)]
    vp = ctypes.c_void_p
    fn = cs._build.bind("msm_small", "bppp_msm_small_wnaf", [vp] * 7 + [ctypes.c_int] * 4 + [vp])
    cs._build.check(fn(*(t.data_ptr() for t in ins + outs), D, B, nthr, lpb, cs._build.stream()),
                    "msm_small_wnaf")
    return tuple(o.to(torch.int64) for o in outs)


def u4_inputs(cs, gen, kernel, D, B, dev):
    """Points (three (D, 16, B)) and K8's GLV halves and masks or K9's
    scalars for D random points and scalars per lane."""
    coords = [c.movedim(1, 0).contiguous() for c in cs.rand_points(gen, (D, B), dev)]
    kk = cs.rand_scalars(gen, (D, B), cs.N_INT, dev)
    ins = cs.glv.glv_halves(kk) if kernel == "msm_small_glv" else (kk.movedim(1, 0).contiguous(),)
    return coords, list(ins)


def u4_launch(cs, kernel, coords, ins, nthr, lpb):
    """This tree's K8 or K9 through its C entry point with nthr threads per
    lane (the split's 2D or D, or 1) and lpb lanes per block."""
    D, _, B = coords[0].shape
    flat = [cs.cuda_curve.flat_i32(t, t.shape) for t in (*coords, *ins)]
    outs = [torch.empty((16, B), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    vp = ctypes.c_void_p
    symbol = "bppp_" + kernel
    fn = cs._build.bind("msm_small_u4", symbol, [vp] * (len(flat) + 3) + [ctypes.c_int] * 4 + [vp])
    cs._build.check(fn(*(t.data_ptr() for t in flat + outs), D, B, nthr, lpb, cs._build.stream()),
                    kernel)
    return tuple(o.to(torch.int64) for o in outs)


def u4_launches(cs, kernel, D):
    """(threads per lane, lanes per block) of every launch the sweep tries:
    the split at each block size, then K8's lane walk (K9 has none)."""
    split = 2 * D if kernel == "msm_small_glv" else D
    out = [(split, threads // split) for threads in U4_SWEEP_BLOCKS]
    return out + ([(1, cs.cuda_msm.U4_LANE_BLOCK)] if kernel == "msm_small_glv" else [])


def sweep(cs, dev, gen, full) -> list:
    out = []
    for B, cands in K3_SWEEP.items():
        sc = cs.rand_scalars(gen, (full.n_points, B), cs.N_INT, dev)
        want = digest(cs, cs.cuda_fixed_base.fixed_msm(full, sc))
        for S in cands:
            out.append(dict(kernel="fixed_msm", F=full.n_points, B=B, slices=S,
                            agree=digest(cs, fixed_msm_slices(cs, full, sc, S)) == want,
                            ms=cs.time_ms(lambda: fixed_msm_slices(cs, full, sc, S))))
    for D in range(1, cs.cuda_msm.DMAX + 1):
        for B in K4_SWEEP_LANES:
            coords, dig = k4_inputs(cs, gen, D, B, dev)
            want = digest(cs, cs.cuda_msm.msm_small_wnaf(*coords, dig))
            for nthr in (2 * D, 1):
                out.append(dict(kernel="msm_small_wnaf", D=D, B=B, threads_per_lane=nthr,
                                agree=digest(cs, msm_small_threads(cs, coords, dig, nthr)) == want,
                                ms=cs.time_ms(lambda: msm_small_threads(cs, coords, dig, nthr))))
    for kernel in U4_KERNELS:
        for D in range(1, cs.cuda_msm.DMAX_U4 + 1):
            for B in K4_SWEEP_LANES:
                coords, ins = u4_inputs(cs, gen, kernel, D, B, dev)
                want = digest(cs, getattr(cs.cuda_msm, kernel)(*coords, *ins))
                for nthr, lpb in u4_launches(cs, kernel, D):
                    out.append(dict(
                        kernel=kernel, D=D, B=B, threads_per_lane=nthr, lanes_per_block=lpb,
                        agree=digest(cs, u4_launch(cs, kernel, coords, ins, nthr, lpb)) == want,
                        ms=cs.time_ms(lambda: u4_launch(cs, kernel, coords, ins, nthr, lpb))))
    return out


def worker(tree: str, with_sweep: bool) -> dict:
    cs = load_chip_smoke(tree)
    dev = torch.device("cuda", 0)
    cs._build.build_all()
    memory = prove_memory(cs, dev)
    gen = np.random.default_rng(404)
    rows = []
    tables = k3_tables(cs, dev)
    for tab, tag, B in tables:
        sc = cs.rand_scalars(gen, (tab.n_points, B), cs.N_INT, dev)
        rows.append(dict(kernel="fixed_msm", row=tag, shape=[16, tab.n_points, B],
                         digest=digest(cs, cs.cuda_fixed_base.fixed_msm(tab, sc)),
                         ms=cs.time_ms(lambda: cs.cuda_fixed_base.fixed_msm(tab, sc))))
    for D, B in [(D, cs.BATCH) for D in range(1, cs.cuda_msm.DMAX + 1)] + [
            (2, cs.BIG_BATCH), (cs.cuda_msm.DMAX, cs.BIG_BATCH), (3, 70), (cs.cuda_msm.DMAX, 333)]:
        coords, dig = k4_inputs(cs, gen, D, B, dev)
        rows.append(dict(kernel="msm_small_wnaf", row=f"D={D}", shape=[D, 16, B],
                         digest=digest(cs, cs.cuda_msm.msm_small_wnaf(*coords, dig)),
                         ms=cs.time_ms(lambda: cs.cuda_msm.msm_small_wnaf(*coords, dig))))
    for kernel in U4_KERNELS:
        for D, B in [(D, cs.BATCH) for D in range(1, cs.cuda_msm.DMAX_U4 + 1)] + [
                (cs.cuda_msm.DMAX_U4, cs.BIG_BATCH), (3, 70), (2, 77)]:
            coords, ins = u4_inputs(cs, gen, kernel, D, B, dev)
            wrapper = getattr(cs.cuda_msm, kernel)
            rows.append(dict(kernel=kernel, row=f"D={D}", shape=[D, 16, B],
                             digest=digest(cs, wrapper(*coords, *ins)),
                             ms=cs.time_ms(lambda: wrapper(*coords, *ins))))
    out = dict(tree=tree, memory=memory, rows=rows)
    if with_sweep:
        out["sweep"] = sweep(cs, dev, gen, tables[0][0])
    return out


def run_worker(tree: str, with_sweep: bool) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree]
    proc = subprocess.run(cmd + (["--sweep"] if with_sweep else []), capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-8000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="an unpacked earlier checkout of the repo")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_designs.py needs a CUDA device")
    if args.worker:
        print(json.dumps(worker(args.worker, args.sweep)), flush=True)
        return 0
    if not args.earlier or not os.path.isdir(os.path.join(args.earlier, "bppp_tpu_torch")):
        raise SystemExit("--earlier must name an unpacked checkout holding bppp_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    old1 = run_worker(args.earlier, False)
    new1 = run_worker(ROOT, True)
    new2 = run_worker(ROOT, True)
    old2 = run_worker(args.earlier, False)
    runs = (old1, new1, new2, old2)
    if len({len(r["rows"]) for r in runs}) != 1:
        raise SystemExit("the two trees walked different tables: "
                         f"{[[x['row'] for x in r['rows']] for r in runs]}")
    rows = []
    for o1, n1, n2, o2 in zip(*(r["rows"] for r in runs)):
        rows.append(dict(kernel=n1["kernel"], row=n1["row"], shape=n1["shape"],
                         earlier_ms=(o1["ms"] + o2["ms"]) / 2, ms=(n1["ms"] + n2["ms"]) / 2,
                         runs_ms=[o1["ms"], n1["ms"], n2["ms"], o2["ms"]],
                         agree=len({o1["digest"], n1["digest"], n2["digest"], o2["digest"]}) == 1))
    swept = [dict(a, ms=(a["ms"] + b["ms"]) / 2, runs_ms=[a["ms"], b["ms"]],
                  agree=a["agree"] and b["agree"]) for a, b in zip(new1["sweep"], new2["sweep"])]
    bad = [r["row"] for r in rows if not r["agree"]] + [str(s) for s in swept if not s["agree"]]
    print(json.dumps(dict(compare=dict(ok=not bad, rows=rows, sweep=swept, memory=dict(
        earlier=[old1["memory"], old2["memory"]], this=[new1["memory"], new2["memory"]])))),
        flush=True)
    print(smi, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
