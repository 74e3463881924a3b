#!/usr/bin/env python3
"""The kernels of this checkout that the port has redesigned — K1
(`f1600`), K2 (`pow_const`), K3 (`fixed_msm`), K4 (`msm_small_wnaf`), K5a
(`pt_add`), K5b (`pt_double`, the table build's doubling chain), K6
(`scalar_mul`), K7 (`tree_sum`), K8 (`msm_small_glv`) and K9
(`msm_small`), and the table build's affine step (`affine_rows`) — against
those of an earlier checkout of the repo, in turns inside one run.

    git archive <earlier commit> | tar -x -C <a git-ignored directory>
    python3 bppp_tpu_torch/tools/compare_designs.py --earlier <that directory> [--only f1600,tree_sum]

`--only` keeps the rows and sweeps of the kernels named (wrapper names, as
in the `kernel` of each row; `build_tables` and `memory` name the table
build's seconds and the prove fixture's memory).

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
    the ragged D = 3 on 70 lanes and D = 2 on 77; the 255 doubles of the
    table build on 49 and 129 generators (`cuda_curve.pt_double_chain`, one
    launch; a tree without it runs `pt_double` 255 times for the same
    result); `cuda_ladder.scalar_mul` at every lane count of K6's sweep and
    on a ragged 203; the table build's affine step on the u64 and WNLA-64
    tables' rows (`cuda_curve.affine_rows`, one launch; a tree without it
    runs the reference's `to_affine`, a K2 inversion of every entry); and
    the seconds of a whole `build_tables` over 49 and 129 generators (the
    u64 and WNLA-64 tables); `cuda_msm.pow_const` for the three exponents
    of the paths (p - 2, (p+1)/4, n - 2) at 1024 and 14,336 lanes; and
    `cuda_curve.pt_add` at 1024 lanes on whole operands, on one point
    broadcast over the lanes and on [:, j] slices of (16, 3, 1024) stacks,
    and at the table build's first and last add (window entries plus a
    strided slice of the doubles broadcast over them: 1,568 and 200,704
    lanes); `cuda_keccak.f1600` at 1024 and 16,384 lanes and a ragged 77;
    `cuda_ladder.tree_sum` at the u64 mirror's (L, lanes) = (17, 1024) and
    at every (L, lanes) pair the standalone WNLA provers give it, scaled to
    a batch of 1024 (the commitments' L = 33 / 65 / 129). Inputs come from
    one seed,
    so both trees get the same ones; each result is hashed as compressed
    points (a table by its words);
  * in this tree's processes, sweeps the kernels' launches through their C
    entry points: K3's slices per lane S, K4's threads per lane (2D or 1)
    across batch sizes, and K8's and K9's split (2D or D threads per lane,
    at 32, 64 and 128 threads per block) and K8's lane walk (one thread
    per lane) at D = 1..3 across the same batch sizes, and K6's split (two
    threads per lane at 32, 64 and 128 threads per block) and lane walk
    (one thread per lane) at 1024-132,096 lanes, each checked against the
    wrapper's result; where K6's two launches come close (12,288 and
    16,384 lanes) it times them in turns over several rounds; and K5a at
    2 and 4 threads per lane (128 threads per block) at 1024-200,704
    lanes, each launch's device time too (torch.profiler: the wrapper's
    time is mostly the host's there), behind the plan's
    `K5A_SPLIT_THREADS`; K1 at 25 threads a sponge and at one, at several
    sponges per block, at 77-16,384 lanes (`f1600_plan`); and K7 at every
    slot count n (1 .. 32, at most L) and 8, 16 or 32 lanes per block at
    each of its rows' shapes and a ragged one (`tree_sum_plan`); a sweep's
    device times come from one profiler session (`chip_smoke.device_times`).

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
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K3_SWEEP = {1024: (8, 16, 32, 64), 16384: (1, 2, 4, 8, 16)}
K4_SWEEP_LANES = (1024, 2048, 4096, 8192, 16384)
U4_SWEEP_BLOCKS = (32, 64, 128)  # threads per block of K8's and K9's split
U4_KERNELS = ("msm_small_glv", "msm_small")
CHAIN_N = 255  # the table build's doubles at window width 8
CHAIN_LANES = (49, 129)  # the u64 and WNLA-64 generator sets
K6_SWEEP_LANES = (1024, 4096, 8192, 12288, 16384, 17408, 32768, 66560, 132096)
# (threads per lane, lanes per block) of K6's launches in the sweep
K6_LAUNCHES = ((2, 16), (2, 32), (2, 64), (1, 32), (1, 64), (1, 128))
# where K6's two launches come close: each timed in turns, this many rounds
K6_CLOSE_LANES = (12288, 16384)
K6_CLOSE_ROUNDS = 6
# the table build's affine step: 32 windows of 2^8 entries of 49 and 129 generators
AFFINE_SHAPES = ((32 * 49, 256), (32 * 129, 256))
# K2: the exponents of fp_inv, fp_sqrt and fn_inv, at the lanes the paths give
POW_LANES = (1024, 14336)
# K5a's sweep: lanes, and threads per lane at 128 threads per block
ADD_SWEEP_LANES = (1024, 4096, 8192, 16384, 32768, 65536, 131072, 200704)
ADD_THREADS = (2, 4)
ADD_TABLE_BITS = (0, 7)  # the table build's adds timed: entries [0, 2^k) + [2^k] G per window
# K1: the verifiers' batches and a ragged one; the sweep of sponges per block
K1_LANES = (1024, 16384, 77)
K1_SWEEP_LANES = (77, 1024, 4096, 8192, 16384)
# (threads per sponge, sponges per block) of K1's launches in the sweep
K1_LAUNCHES = ((25, 4), (25, 8), (25, 16), (25, 32), (1, 32), (1, 64), (1, 128))
# K7: the u64 mirror's sum (the WNLA provers' are recorded), a ragged one;
# the sweep of slots per lane and lanes per block
K7_SHAPES = ((17, 1024),)
K7_RAGGED = (7, 93)
K7_SWEEP_SLOTS = (1, 2, 4, 8, 16, 32)
K7_SWEEP_LPB = (8, 16, 32)


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


def walked_shapes(cs, dev):
    """What a small u64 prove and the standalone WNLA provers (commit +
    prove at batch 2) give K3 and K7. -> ([(tables, tag, lanes)]: the u64
    table at 1024 and 16384 lanes, its `gv` subset, then every table and
    subset the provers walk, in the order they are first walked; [(L,
    lanes)]: K7_SHAPES and every pair the WNLA provers give K7, its lanes
    scaled from the batch of 2 to one of 1024)."""
    log = cs.new_shape_log()
    with cs.recording_shapes(log, "prove"):
        _, d, rng = cs.u64_fixture(cs.SEED, 4, device=dev, tables="auto")
        pbt = cs.u64_prove_batch(rng, [0, 1, 2, 3], 4, device=dev)
        d.prove(pbt.x_words, pbt.s, cs.Transcript(cs.LABEL, batch=(4,), device=dev), pbt.blind)
    sums = set(K7_SHAPES) | {(L, lanes // 4 * cs.BATCH) for L, lanes in log["tree_sum"]}
    for sz in cs.WNLA_SIZES:
        log["tree_sum"] = set()
        with cs.recording_shapes(log, f"wnla{sz}"):
            fx = cs.wnla_fixture(f"{cs.SEED} wnla {sz}", sz, sz, 2, device=dev, tables="auto")
            fx.dev.prove(fx.dev.commit(fx.l, fx.n),
                         cs.Transcript(fx.label, batch=(2,), device=dev), fx.l, fx.n)
        sums |= {(L, lanes // 2 * cs.BATCH) for L, lanes in log["tree_sum"]}
    full, gv = d.tables["full"], d.tables["gv"]
    out = [(full, "F=49", cs.BATCH), (full, "F=49", cs.BIG_BATCH), (gv, "F=17 gv", cs.BATCH)]
    walked = [(t, w) for t, w in log["fixed_msm"].values() if t is not full and t is not gv]
    return (out + [(t, f"F={t.n_points} {w} #{i}", cs.BATCH) for i, (t, w) in enumerate(walked)],
            sorted(sums))


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


def double_chain(cs, p, n):
    """n successive doubles of p: one launch where the tree has the chain,
    n single launches where it has not. -> three (16, n, B)."""
    cc = cs.cuda_curve
    if hasattr(cc, "pt_double_chain"):
        return cc.pt_double_chain(*p, n)
    outs, q = [], tuple(p)
    for _ in range(n):
        q = cc.pt_double(*q)
        outs.append(q)
    return tuple(torch.stack([o[c] for o in outs], dim=1) for c in range(3))


def affine_step(cs, p):
    """The table build's affine step over coords (16, M, NE): one launch of
    `affine_rows` where the tree has it, the reference's `to_affine` (one
    K2 inversion per entry) where it has not. -> (x, y), (16, M, NE)."""
    if hasattr(cs.cuda_curve, "affine_rows"):
        return cs.cuda_curve.affine_rows(*p)
    shape = p.x.shape
    x, y, _ = cs.dc.to_affine(cs.dc.PointJ(*(c.reshape(16, -1) for c in p)))
    return x.reshape(shape), y.reshape(shape)


def affine_inputs(cs, gen, M, NE, dev):
    """M rows of NE random points, each row's first entry the identity, as
    a table's are."""
    p = cs.rand_points(gen, (M, NE), dev)
    first = torch.zeros((M, NE), dtype=torch.bool, device=dev)
    first[:, 0] = True
    return cs.dc.pt_select(first, cs.dc.identity((M, NE), device=dev), p)


def add_inputs(cs, gen, dev) -> list:
    """[(tag, p, q)] of K5a's rows: whole operands at 1024 lanes (lane 0 a
    doubling), one point broadcast over them, [:, j] slices of (16, 3,
    1024) stacks, and the table build's first and last adds: entries (16,
    32, 49, 2^k) plus a k::8 slice of the 256 doubles of 49 generators
    broadcast over the entries' last axis."""
    B = cs.BATCH
    p, q = cs.rand_points(gen, (B,), dev), cs.rand_points(gen, (B,), dev)
    q = cs.dc.pt_select(torch.arange(B, device=dev) == 0, p, q)
    one = cs.dc.PointJ(*(c[:, :1] for c in cs.rand_points(gen, (1,), dev)))
    ps, qs = cs.rand_points(gen, (3, B), dev), cs.rand_points(gen, (3, B), dev)
    out = [(f"B={B}", p, q), (f"broadcast B={B}", p, one),
           (f"strided B={B}", cs.dc.PointJ(*(c[:, 1] for c in ps)),
            cs.dc.PointJ(*(c[:, 1] for c in qs)))]
    dbl = cs.rand_points(gen, (256, 49), dev)
    for k in ADD_TABLE_BITS:
        ents = cs.rand_points(gen, (32, 49, 1 << k), dev)
        step = cs.dc.PointJ(*(d[:, k::8, :, None] for d in dbl))
        out.append((f"table build k={k} B={32 * 49 << k}", ents, step))
    return out


def timed_sweep(cs, entries) -> list:
    """entries: [(row dict, launch, want digest, digest function)] -> the
    rows with `agree`, `ms` (CUDA events around the call) and `device_ms`
    (the hand-written kernels' device time per call, every entry in one
    profiler session)."""
    out = []
    for row, launch, want, dig in entries:
        out.append(dict(row, agree=dig(launch()) == want, ms=cs.time_ms(launch)))
    for row, ms in zip(out, cs.device_times([e[1] for e in entries])):
        row["device_ms"] = ms
    return out


def add_sweep(cs, gen, dev) -> list:
    """K5a through its launch helper at each threads-per-lane count,
    checked against the wrapper."""
    entries = []
    for B in ADD_SWEEP_LANES:
        p, q = cs.rand_points(gen, (B,), dev), cs.rand_points(gen, (B,), dev)
        ins = (*p, *q)
        want = limb_digest(cs.cuda_curve.pt_add(*ins))
        for T in ADD_THREADS:
            lpb = 128 // T
            launch = (lambda ins=ins, shape=p.x.shape, T=T, lpb=lpb:
                      cs.cuda_curve.pt_add_launch(ins, shape, T, lpb))
            entries.append((dict(kernel="pt_add", B=B, threads_per_lane=T, lanes_per_block=lpb),
                            launch, want, limb_digest))
    return timed_sweep(cs, entries)


def keccak_sweep(cs, gen, dev) -> list:
    """K1 through its launch helper at 25 threads or one per sponge and at
    each number of sponges per block, checked against the wrapper byte for
    byte."""
    entries = []
    for B in K1_SWEEP_LANES:
        st = torch.from_numpy(gen.integers(0, 256, size=(200, B))).to(dev)
        want = limb_digest([cs.cuda_keccak.f1600(st)])
        for nthr, lpb in K1_LAUNCHES:
            entries.append((dict(kernel="f1600", B=B, threads_per_lane=nthr, lanes_per_block=lpb),
                            lambda st=st, t=nthr, lpb=lpb: [cs.cuda_keccak.f1600_launch(st, t, lpb)],
                            want, limb_digest))
    return timed_sweep(cs, entries)


def tree_sum_sweep(cs, gen, dev, shapes) -> list:
    """K7 through its launch helper at each (slots per lane, lanes per
    block) on each (L, lanes) of `shapes`, checked against the wrapper as
    points (the slots change the order of the adds)."""
    entries = []
    for L, B in shapes:
        p = cs.rand_points(gen, (L, B), dev)
        want = digest(cs, cs.cuda_ladder.tree_sum(*p))
        for n in K7_SWEEP_SLOTS:
            for lpb in K7_SWEEP_LPB:
                if n > L or n * lpb > cs.cuda_ladder.K7_BLOCK:
                    continue
                entries.append((dict(kernel="tree_sum", L=L, B=B, slots_per_lane=n,
                                     lanes_per_block=lpb),
                                lambda p=p, n=n, lpb=lpb: cs.cuda_ladder.tree_sum_launch(*p, n, lpb),
                                want, lambda xyz: digest(cs, xyz)))
    return timed_sweep(cs, entries)


def limb_digest(ts) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()


def table_build_seconds(cs, pts, reps: int = 3):
    """(median seconds of `build_tables` over pts, digest of its words)."""
    times, tab = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab = cs.cuda_fixed_base.build_tables(pts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), hashlib.sha256(tab.words.cpu().numpy().tobytes()).hexdigest()


def scalar_mul_launch(cs, ins, nthr, lpb):
    """This tree's K6 through its C entry point with nthr threads per lane
    (2, the split, or 1) and lpb lanes per block."""
    B = ins[0].shape[1]
    flat = [cs.cuda_curve.flat_i32(t, t.shape) for t in ins]
    outs = [torch.empty((16, B), dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    vp = ctypes.c_void_p
    fn = cs._build.bind("ladder", "bppp_scalar_mul", [vp] * 7 + [ctypes.c_int] * 3 + [vp])
    cs._build.check(fn(*(t.data_ptr() for t in flat + outs), B, nthr, lpb, cs._build.stream()),
                    "scalar_mul")
    return tuple(o.to(torch.int64) for o in outs)


def k6_inputs(cs, gen, B, dev):
    return list(cs.rand_points(gen, (B,), dev)) + [cs.rand_scalars(gen, (B,), cs.N_INT, dev)]


def sweep(cs, dev, gen, full, k7_shapes, only) -> list:
    out = []
    if only("pt_add"):
        out += add_sweep(cs, gen, dev)
    if only("f1600"):
        out += keccak_sweep(cs, gen, dev)
    if only("tree_sum"):
        out += tree_sum_sweep(cs, gen, dev, k7_shapes + [K7_RAGGED])
    if only("fixed_msm"):
        for B, cands in K3_SWEEP.items():
            sc = cs.rand_scalars(gen, (full.n_points, B), cs.N_INT, dev)
            want = digest(cs, cs.cuda_fixed_base.fixed_msm(full, sc))
            for S in cands:
                out.append(dict(kernel="fixed_msm", F=full.n_points, B=B, slices=S,
                                agree=digest(cs, fixed_msm_slices(cs, full, sc, S)) == want,
                                ms=cs.time_ms(lambda: fixed_msm_slices(cs, full, sc, S))))
    if only("msm_small_wnaf"):
        for D in range(1, cs.cuda_msm.DMAX + 1):
            for B in K4_SWEEP_LANES:
                coords, dig = k4_inputs(cs, gen, D, B, dev)
                want = digest(cs, cs.cuda_msm.msm_small_wnaf(*coords, dig))
                for nthr in (2 * D, 1):
                    out.append(dict(
                        kernel="msm_small_wnaf", D=D, B=B, threads_per_lane=nthr,
                        agree=digest(cs, msm_small_threads(cs, coords, dig, nthr)) == want,
                        ms=cs.time_ms(lambda: msm_small_threads(cs, coords, dig, nthr))))
    for kernel in U4_KERNELS:
        if not only(kernel):
            continue
        for D in range(1, cs.cuda_msm.DMAX_U4 + 1):
            for B in K4_SWEEP_LANES:
                coords, ins = u4_inputs(cs, gen, kernel, D, B, dev)
                want = digest(cs, getattr(cs.cuda_msm, kernel)(*coords, *ins))
                for nthr, lpb in u4_launches(cs, kernel, D):
                    out.append(dict(
                        kernel=kernel, D=D, B=B, threads_per_lane=nthr, lanes_per_block=lpb,
                        agree=digest(cs, u4_launch(cs, kernel, coords, ins, nthr, lpb)) == want,
                        ms=cs.time_ms(lambda: u4_launch(cs, kernel, coords, ins, nthr, lpb))))
    if not only("scalar_mul"):
        return out
    for B in K6_SWEEP_LANES:
        ins = k6_inputs(cs, gen, B, dev)
        want = digest(cs, cs.cuda_ladder.scalar_mul(*ins))
        for nthr, lpb in K6_LAUNCHES:
            out.append(dict(kernel="scalar_mul", B=B, threads_per_lane=nthr, lanes_per_block=lpb,
                            agree=digest(cs, scalar_mul_launch(cs, ins, nthr, lpb)) == want,
                            ms=cs.time_ms(lambda: scalar_mul_launch(cs, ins, nthr, lpb))))
    # the close calls: the split and the lane walk at 64 lanes per block in
    # turns (split, lane, lane, split, ...), every round's time kept
    for B in K6_CLOSE_LANES:
        ins = k6_inputs(cs, gen, B, dev)
        want = digest(cs, cs.cuda_ladder.scalar_mul(*ins))
        times = {2: [], 1: []}
        for r in range(K6_CLOSE_ROUNDS):
            for nthr in ((2, 1) if r % 2 == 0 else (1, 2)):
                times[nthr].append(cs.time_ms(lambda: scalar_mul_launch(cs, ins, nthr, 64)))
        for nthr, ts in times.items():
            out.append(dict(kernel="scalar_mul_in_turns", B=B, threads_per_lane=nthr,
                            lanes_per_block=64, runs_ms=ts, ms=statistics.median(ts),
                            agree=digest(cs, scalar_mul_launch(cs, ins, nthr, 64)) == want))
    return out


def worker(tree: str, with_sweep: bool, only) -> dict:
    cs = load_chip_smoke(tree)
    dev = torch.device("cuda", 0)
    cs._build.build_all()
    memory = prove_memory(cs, dev) if only("memory") else None
    gen = np.random.default_rng(404)
    rows, calls = [], []

    def add(kernel, row, shape, fn, dig):
        """A row: the digest of fn's result, its time by CUDA events; its
        device time comes from one profiler session over every row."""
        rows.append(dict(kernel=kernel, row=row, shape=shape, digest=dig(fn()), ms=cs.time_ms(fn)))
        calls.append(fn)

    points = lambda xyz: digest(cs, xyz)
    tables, k7_shapes = walked_shapes(cs, dev) if only("fixed_msm") or only("tree_sum") else ([], [])
    if only("f1600"):
        for B in K1_LANES:
            st = torch.from_numpy(gen.integers(0, 256, size=(200, B))).to(dev)
            add("f1600", f"B={B}", [200, B], lambda st=st: [cs.cuda_keccak.f1600(st)], limb_digest)
    if only("tree_sum"):
        for L, B in k7_shapes + [K7_RAGGED]:
            p = cs.rand_points(gen, (L, B), dev)
            add("tree_sum", f"L={L} B={B}", [16, L, B], lambda p=p: cs.cuda_ladder.tree_sum(*p),
                points)
    if only("fixed_msm"):
        for tab, tag, B in tables:
            sc = cs.rand_scalars(gen, (tab.n_points, B), cs.N_INT, dev)
            add("fixed_msm", tag, [16, tab.n_points, B],
                lambda tab=tab, sc=sc: cs.cuda_fixed_base.fixed_msm(tab, sc), points)
    if only("msm_small_wnaf"):
        for D, B in [(D, cs.BATCH) for D in range(1, cs.cuda_msm.DMAX + 1)] + [
                (2, cs.BIG_BATCH), (cs.cuda_msm.DMAX, cs.BIG_BATCH), (3, 70),
                (cs.cuda_msm.DMAX, 333)]:
            coords, dig = k4_inputs(cs, gen, D, B, dev)
            add("msm_small_wnaf", f"D={D}", [D, 16, B],
                lambda coords=coords, dig=dig: cs.cuda_msm.msm_small_wnaf(*coords, dig), points)
    for kernel in U4_KERNELS:
        if not only(kernel):
            continue
        for D, B in [(D, cs.BATCH) for D in range(1, cs.cuda_msm.DMAX_U4 + 1)] + [
                (cs.cuda_msm.DMAX_U4, cs.BIG_BATCH), (3, 70), (2, 77)]:
            coords, ins = u4_inputs(cs, gen, kernel, D, B, dev)
            wrapper = getattr(cs.cuda_msm, kernel)
            add(kernel, f"D={D}", [D, 16, B],
                lambda wrapper=wrapper, coords=coords, ins=ins: wrapper(*coords, *ins), points)
    if only("pt_double"):
        for F in CHAIN_LANES:
            p = cs.rand_points(gen, (F,), dev)
            add("pt_double", f"n={CHAIN_N} B={F}", [16, CHAIN_N, F],
                lambda p=p: double_chain(cs, p, CHAIN_N), points)
    if only("scalar_mul"):
        for B in K6_SWEEP_LANES + (203,):
            ins = k6_inputs(cs, gen, B, dev)
            add("scalar_mul", f"B={B}", [16, B], lambda ins=ins: cs.cuda_ladder.scalar_mul(*ins),
                points)
    if only("affine_rows"):
        for M, NE in AFFINE_SHAPES:
            p = affine_inputs(cs, gen, M, NE, dev)
            add("affine_rows", f"M={M} NE={NE}", [16, M, NE], lambda p=p: affine_step(cs, p),
                limb_digest)
    if only("pow_const"):
        for B in POW_LANES:
            for tag, e, kind in cs.POW_NAMED:
                x = cs.rand_scalars(gen, (B,), cs.P_INT if kind == "p" else cs.N_INT, dev)
                add("pow_const", f"{tag} B={B}", [16, B],
                    lambda x=x, e=e, kind=kind: [cs.cuda_msm.pow_const(x, e, kind)], limb_digest)
    if only("pt_add"):
        for tag, p, q in add_inputs(cs, gen, dev):
            add("pt_add", tag, list(p.x.shape), lambda p=p, q=q: cs.cuda_curve.pt_add(*p, *q),
                limb_digest)
    for row, ms in zip(rows, cs.device_times(calls)):
        row["device_ms"] = ms
    if only("build_tables"):
        for F in CHAIN_LANES:
            seconds, words = table_build_seconds(cs, cs.rand_points(gen, (F,), dev))
            rows.append(dict(kernel="build_tables", row=f"F={F}", shape=[F], digest=words,
                             ms=seconds * 1e3, device_ms=None))
    out = dict(tree=tree, memory=memory, rows=rows)
    if with_sweep:
        out["sweep"] = sweep(cs, dev, gen, tables[0][0] if tables else None, k7_shapes, only)
    return out


def run_worker(tree: str, with_sweep: bool, only: str) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree]
    cmd += ["--sweep"] if with_sweep else []
    cmd += ["--only", only] if only else []
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-8000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="an unpacked earlier checkout of the repo")
    ap.add_argument("--only", default="", help="comma-separated kernels (wrapper names) to keep")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_designs.py needs a CUDA device")
    kept = {k for k in args.only.split(",") if k}
    only = lambda kernel: not kept or kernel in kept
    if args.worker:
        print(json.dumps(worker(args.worker, args.sweep, only)), flush=True)
        return 0
    if not args.earlier or not os.path.isdir(os.path.join(args.earlier, "bppp_tpu_torch")):
        raise SystemExit("--earlier must name an unpacked checkout holding bppp_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    old1 = run_worker(args.earlier, False, args.only)
    new1 = run_worker(ROOT, True, args.only)
    new2 = run_worker(ROOT, True, args.only)
    old2 = run_worker(args.earlier, False, args.only)
    runs = (old1, new1, new2, old2)
    if len({len(r["rows"]) for r in runs}) != 1:
        raise SystemExit("the two trees walked different tables: "
                         f"{[[x['row'] for x in r['rows']] for r in runs]}")
    mean = lambda *xs: None if None in xs else sum(xs) / len(xs)
    rows = []
    for o1, n1, n2, o2 in zip(*(r["rows"] for r in runs)):
        rows.append(dict(kernel=n1["kernel"], row=n1["row"], shape=n1["shape"],
                         earlier_ms=mean(o1["ms"], o2["ms"]), ms=mean(n1["ms"], n2["ms"]),
                         runs_ms=[o1["ms"], n1["ms"], n2["ms"], o2["ms"]],
                         earlier_device_ms=mean(o1["device_ms"], o2["device_ms"]),
                         device_ms=mean(n1["device_ms"], n2["device_ms"]),
                         agree=len({o1["digest"], n1["digest"], n2["digest"], o2["digest"]}) == 1))
    swept = [dict(a, ms=mean(a["ms"], b["ms"]), runs_ms=[a["ms"], b["ms"]],
                  device_ms=mean(a.get("device_ms"), b.get("device_ms")),
                  agree=a["agree"] and b["agree"]) for a, b in zip(new1["sweep"], new2["sweep"])]
    bad = [r["row"] for r in rows if not r["agree"]] + [str(s) for s in swept if not s["agree"]]
    print(json.dumps(dict(compare=dict(ok=not bad, rows=rows, sweep=swept, memory=dict(
        earlier=[old1["memory"], old2["memory"]], this=[new1["memory"], new2["memory"]])))),
        flush=True)
    print(smi, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
