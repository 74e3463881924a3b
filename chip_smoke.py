#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --parallel-only   # the build, the verify phase and the parallel phase
    python3 chip_smoke.py --profile [--path verify|mirror|prove|verify_glv|...|circuit_ac|
                                     circuit_reciprocal|wire|pippenger]
                                     # where one batch of that path spends its time

Builds the CUDA kernels of `bppp_tpu_torch/csrc/` from source, holds each
kernel against its plain PyTorch version on the card (exact equality),
and drives the port's paths at a batch of 1024 u64 range proofs:

  verify  `U64RangeProofDevice.verify(fast=True)`, the collapsed verifier
          (also at a batch of 16384); the fixture's table build is timed
          and must launch the doubling chain (K5b) once;
  mirror  `verify(fast=False)`, the verifier that folds the generators per
          round, on the same batch: its mask equals the expected one and
          the fast verifier's;
  prove   `commit_value` + `prove`: the proof bytes of the distinct lanes
          equal the host oracle's under replayed blinding draws, and both
          verifiers accept every produced proof;
  variants  the three paths again under BPPP_WNAF=0 (small MSMs through
          K8, `msm_small_glv`) and under BPPP_GLV=0 (K9, `msm_small`): the
          same masks, the default prover's bytes on every lane, and K4
          launched on none of them;
  wnla    the standalone weight-norm linear argument at |l| = |n| = 16,
          32 and 64: commit + prove with the distinct lanes' bytes equal to
          the oracle's, both verifiers on honest and tampered proofs; each
          table build timed, one K5b launch each;
  circuit the standalone arithmetic circuit on its generic dense path:
          ac_works without tables and the reciprocal-decomposition circuit
          at the u64 dims with the u64 tables, 4 distinct witnesses tiled
          over the batch; prove bytes equal the oracle's, both verifiers
          accept the honest lanes and reject a tampered C_S and a tampered
          WNLA scalar;
  wire    the verify phase's proofs as 525-byte blobs, tampered in their
          bytes as the verify phase tampers its tensors, through
          `native.pack_batch` into both u64 verifiers; the packed tensors
          equal the verify phase's, the masks the expected one; the C++
          host engine's `u64_verify` timed on 16 blobs as a host baseline;
  entry   `bppp_tpu_torch.entry.entry()`: its step rejects every lane of
          its zero arguments and gives the wire mask on the wire arguments;
  pippenger  `ops.pippenger.msm_pippenger` against `curve.msm` (ladder +
          tree) at 33, 65 and 129 points per lane (the WNLA-16/32/64 final
          MSMs) over the batch, with an identity point, a zero scalar, a
          repeated point and a point beside its negation; equal as points on
          every lane, both routes timed in turns (their device times in the
          kernels phase's profiler session, a `pippenger_device` line); K7
          (incomplete adds) never launched by Pippenger.
  parallel  the scale-out layer (`bppp_tpu_torch/parallel/`) at world size 1
          over NCCL in this process, then as four ranks sharing the card over
          gloo (NCCL refuses two ranks on one card): dp, the verify batch cut
          by `shard_batch`, the verify phase's mask; tp, `msm_sharded` at 48
          and 128 points with an equal-partials and an identity-partial lane,
          `curve.msm`'s points; sp, `prove_sharded` on WNLA-64, the
          single-card prover's bytes on every lane (and the oracle's on the
          distinct ones), the mirror verifier on them; per rank and part the
          launches, ms and collectives; then `dryrun_multichip(4)`.

For each path it checks that every kernel of that path was launched and
that no plain version was. The kernel comparison comes after the paths,
at the u64 path's shapes and at every shape the paths gave K1 (each lane
count), K3 (each table and row subset), K5a and K6 (each lane count), K5b
(each lane count and chain length) and K7 (each point count and lane
count), which are recorded as the paths run. Every phase prints one JSON
line, and a `walls` line each phase's seconds; any mismatch or exception
ends the run with a non-zero exit code. There is no CPU route: without a CUDA
device the script fails.

Bounds (`bound_ms`) are the least time the card could take for the same
work: bytes moved (each input read once, each output written once) over
3.35e12 B/s, or 32-bit integer operations over 33.5e12 op/s — NVIDIA's
H100 SXM data sheet gives 67 TFLOP/s for fp32 outside the tensor cores,
and the SM has half as many int32 lanes as fp32 lanes; a multiply-add
counts as two operations. Work that depends on the data (zero digits add
nothing) is counted from this run's inputs. Every row also gives the
device time of the hand-written kernels per call (`device_ms`,
torch.profiler, all rows in one profiler session at the end of the phase)
beside the wrapper's time by CUDA events (`kernel_ms`), which includes the
host's work of the call.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from bppp_tpu_torch import native
from bppp_tpu_torch.entry import dryrun_multichip, entry
from bppp_tpu_torch.models import circuit_fixture, u64_fixture, u64_prove_batch, wnla_fixture
from bppp_tpu_torch.ops import _build
from bppp_tpu_torch.ops import cuda_curve, cuda_fixed_base, cuda_keccak, cuda_ladder, cuda_msm
from bppp_tpu_torch.ops import curve as dc
from bppp_tpu_torch.ops import field as f
from bppp_tpu_torch.ops import glv
from bppp_tpu_torch.ops import pippenger
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N as N_INT
from bppp_tpu_torch.oracle.field import P as P_INT
from bppp_tpu_torch.oracle.merlin import Transcript as HostTranscript
from bppp_tpu_torch.parallel import multihost
from bppp_tpu_torch.parallel.mesh import batch_slice, make_mesh, map_tensors, msm_sharded, shard_batch
from bppp_tpu_torch.parallel.wnla_shard import _sharded_rounds, prove_sharded
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol.u64 import U64RangeProofDevice, build_u64_tables
from bppp_tpu_torch.protocol.wnla import WNLADevice
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import ReplayRng

LABEL = b"u64 range proof"
SEED = "chip smoke"
BATCH = 1024
BIG_BATCH = 16384
PLAIN_B = 64  # lanes the slow plain versions run on (taken from the same inputs)

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# 32-bit multiply-adds in one modular multiply of csrc/field.cuh: the 8 x 8
# schoolbook product (a square: 28 off-diagonal and 8 diagonal products)
# plus the folds (p: 8 + 1; n: 40 + 25 + 5 + 5)
MAD_MUL_P, MAD_SQR_P = 64 + 9, 36 + 9
MAD_MUL_N, MAD_SQR_N = 64 + 75, 36 + 75
# per point formula: a complete or incomplete Jacobian add (12 multiplies,
# 4 squares), a mixed add (8, 3), a double (2, 5)
MAD_ADD = 12 * MAD_MUL_P + 4 * MAD_SQR_P
MAD_MIXED = 8 * MAD_MUL_P + 3 * MAD_SQR_P
MAD_DBL = 2 * MAD_MUL_P + 5 * MAD_SQR_P

COUNTERS = (cuda_keccak, cuda_msm, cuda_fixed_base, cuda_curve, cuda_ladder)


@contextlib.contextmanager
def switches(env: dict):
    """Set the environment variables of `env` for the block, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def variant_kernel(env: dict) -> str:
    """The small-MSM kernel `curve.msm` takes under the switches of `env`."""
    with switches(env):
        return dc.small_msm_variant()


# the kernels each path must launch (and no plain version)
PATH_KERNELS = {
    "verify": ("f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add", "pt_double",
               "affine_rows"),
    "mirror": ("f1600", "pow_const", "msm_small_wnaf", "pt_add", "scalar_mul", "tree_sum"),
    "prove": ("f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add"),
}
BASE_PATHS = tuple(PATH_KERNELS)
# the kernels a path must not launch
PATH_BANNED = {}
# the non-default small-MSM switches: BPPP_WNAF=0 takes K8, BPPP_GLV=0 K9
VARIANTS = {"glv": {"BPPP_WNAF": "0"}, "noglv": {"BPPP_GLV": "0"}}
# (the variant runs reuse the verify phase's instance: its table build, the
# only user of pt_double and affine_rows, is not part of them)
for _tag, _env in VARIANTS.items():
    for _path in BASE_PATHS:
        PATH_KERNELS[f"{_path}_{_tag}"] = tuple(
            variant_kernel(_env) if k == "msm_small_wnaf" else k for k in PATH_KERNELS[_path]
            if k not in ("pt_double", "affine_rows"))
        PATH_BANNED[f"{_path}_{_tag}"] = ("msm_small_wnaf",)
# the standalone WNLA at |l| = |n| = 16, 32, 64: commit (ladder + sum over
# 1 + 2 sz points), prove, mirror verify, collapsed verify
WNLA_SIZES = (16, 32, 64)
TAMPERED = 5  # the lane whose WNLA proof the wnla phase tampers
for _sz in WNLA_SIZES:
    PATH_KERNELS[f"wnla{_sz}"] = ("f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add",
                                  "scalar_mul", "tree_sum")
# the standalone circuit (fixture with its table build, prove, both
# verifiers): ac_works without tables (Straus MSMs: K5a adds and K5b
# doubles; the WNLA mirror's folds over more than 6 points: K6 + K7), the
# reciprocal circuit with the u64 tables (built by its fixture)
PATH_KERNELS["circuit_ac"] = ("f1600", "pow_const", "msm_small_wnaf", "pt_add", "pt_double",
                              "scalar_mul", "tree_sum")
PATH_KERNELS["circuit_reciprocal"] = PATH_KERNELS["verify"] + ("scalar_mul", "tree_sum")
# wire blobs into both u64 verifiers (the verify phase's instance and tables)
PATH_KERNELS["wire"] = ("f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add",
                        "scalar_mul", "tree_sum")
# the entry hook: its own u64 fixture (one table build) and fast verify steps
PATH_KERNELS["entry"] = PATH_KERNELS["verify"]
# Pippenger: complete adds and the windows' doubling chain, never the
# ladder or the sum with incomplete adds
PATH_KERNELS["pippenger"] = ("pt_add", "pt_double")
PATH_BANNED["pippenger"] = ("tree_sum", "scalar_mul")
PIPPENGER_L = (33, 65, 129)
# the lanes the circuit phase tampers: C_S, and the first WNLA scalar
CIRCUIT_TAMPERED = {"c_s": 5, "wnla.l": 6}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def reset_counts() -> None:
    for mod in COUNTERS:
        for d in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k in d:
                d[k] = 0


def read_counts():
    launches, plain = {}, {}
    for mod in COUNTERS:
        launches.update(mod.LAUNCHES)
        plain.update(mod.PLAIN_CALLS)
    return launches, plain


def time_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median time of `fn()` in milliseconds, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def timed_once(fn):
    """(result, milliseconds by CUDA events) of one cold call of `fn`."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def device_rows(prof):
    """[(kernel symbol, device ms, launches)] of what a torch.profiler run
    saw on the card."""
    rows = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        rows.append((e.key, float(us) / 1e3, int(e.count)))
    return rows


MARK_CYCLES = 1000  # a marker kernel's spin (torch.cuda._sleep) between measured calls


def device_times(fns, reps: int = 10, tries: int = 2) -> list:
    """[device ms per call of each fn of `fns`]: the time of the hand-written
    kernels (HAND_WRITTEN) its calls launch, without the host's work around
    them or the wrappers' eager copies, by torch.profiler; None where the
    profiler saw none of them (not measured). All of `fns` run in ONE
    profiler session on one stream, a marker kernel (`torch.cuda._sleep`)
    before each fn's calls and after the last: in the card's own order of
    execution, a kernel belongs to the fn whose marker it follows. Only the
    session's last len(fns) + 1 markers count, and a session that shows
    fewer is run again, up to `tries` times. (One profiler session per
    measurement gave no device events from the twelfth session of a process
    on; a range's kernels found by host time mixed with the next range's
    where the ranges were short; a session once showed too few markers,
    PERF.md §7.)"""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                torch.cuda._sleep(MARK_CYCLES)
                for _ in range(reps):
                    fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        seq = sorted((e.time_range.start, "spin_kernel" in e.name,
                      e.time_range.end - e.time_range.start)
                     for e in prof.events() if "cuda" in str(e.device_type).lower()
                     and ("spin_kernel" in e.name or any(h in e.name for h in HAND_WRITTEN)))
        marks = [k for k, (_, mark, _) in enumerate(seq) if mark]
        if len(marks) > len(fns):
            break
    else:
        return [None] * len(fns)
    marks = marks[len(marks) - len(fns) - 1:]
    out = []
    for lo, hi in zip(marks, marks[1:]):
        us = [d for _, mark, d in seq[lo + 1:hi]]
        out.append(sum(us) / 1e3 / reps if us else None)
    return out


def measure_device(rows) -> None:
    """Set `device_ms` of every row that carries a `device_fn` (and drop
    the function), all rows in one profiler session (`device_times`)."""
    timed = [r for r in rows if "device_fn" in r]
    for r, ms in zip(timed, device_times([r.pop("device_fn") for r in timed])):
        r["device_ms"] = ms


def bound(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(a, b) -> int:
    a = [a] if isinstance(a, torch.Tensor) else list(a)
    b = [b] if isinstance(b, torch.Tensor) else list(b)
    assert len(a) == len(b)
    worst = 0
    for x, y in zip(a, b):
        assert x.shape == y.shape, (x.shape, y.shape)
        if x.numel():
            worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return worst


def rand_scalars(gen, shape, modulus: int, dev):
    """Uniform values below `modulus` as (16, *shape) limb tensors."""
    n = int(np.prod(shape))
    raw = gen.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    # p and n exceed 0xFFFF * 2^240: only a value whose top limb is 0xFFFF
    # can reach the modulus, so only those lanes are reduced on the host
    top = np.nonzero(raw[15] == 0xFFFF)[0]
    if top.size:
        raw[:, top] = f.ints_to_limbs([v % modulus for v in f.limbs_to_ints(raw[:, top])])
    return torch.from_numpy(raw).reshape((16,) + tuple(shape)).to(dev)


def rand_points(gen, shape, dev):
    """Random non-identity points in random Jacobian representations,
    coords (16, *shape): multiples of the generator made on the card."""
    n = int(np.prod(shape))
    base = [oc.GENERATOR.mul(int(gen.integers(1, 1 << 62))) for _ in range(8)]
    pts = dc.from_int_points(base, device=dev)  # (16, 8)
    idx = torch.from_numpy(gen.integers(0, 8, size=n)).to(dev)
    p = dc.PointJ(*(c[:, idx] for c in pts))
    # spread them: P <- 2P + base[j], rounds with fresh j. After r rounds a
    # point is one of 8^(r + 1); with r = 3 two points of one lane were equal
    # once in 4096, and a 1024-lane sum with incomplete adds (K7's contract,
    # as the reference's) then met the doubling that the complete reduction
    # it is also held against handles. With r = 10 it is once in 8.6e9.
    for _ in range(10):
        j = torch.from_numpy(gen.integers(0, 8, size=n)).to(dev)
        p = dc.pt_add(dc.pt_double(p), dc.PointJ(*(c[:, j] for c in pts)))
    return dc.PointJ(*(c.reshape((16,) + tuple(shape)) for c in p))


# -- phase: kernels ---------------------------------------------------------------


def plain_lanes(B: int, dev):
    """The lanes of a B-lane launch that a slow plain version is run on:
    the first and the last PLAIN_B / 2, so the first block, the last full
    block and the partial tail block of a ragged batch are all compared."""
    if B <= PLAIN_B:
        return torch.arange(B, device=dev)
    half = PLAIN_B // 2
    return torch.cat([torch.arange(half, device=dev), torch.arange(B - half, B, device=dev)])


def kernel_of(row_name: str) -> str:
    """The kernel a row of the kernels phase stands for: "pow_const[fp_inv] ragged" -> "pow_const"."""
    return row_name.split("[")[0].split(" ")[0]


def check_keccak(gen, dev, B, stride=1):
    """K1 on B random sponges (lane 0 all zero bytes, the last all 0xFF),
    read in place from every stride-th lane of a (200, stride B) state,
    against the plain version on every byte."""
    st = torch.from_numpy(gen.integers(0, 256, size=(200, stride * B))).to(dev)[:, ::stride]
    st[:, 0] = 0
    st[:, B - 1] = 255
    got = cuda_keccak.f1600(st)
    want = cuda_keccak.f1600_plain(st)
    err = max_err(got, want)
    ms = time_ms(lambda: cuda_keccak.f1600(st))
    plain_ms = time_ms(lambda: cuda_keccak.f1600_plain(st), reps=3)
    # per round about 216 64-bit logic operations = 432 32-bit ones; int64
    # bytes in and out
    b_ms, by = bound(2 * 200 * 8 * B, 24 * 432 * B)
    nthr, lpb = cuda_keccak.f1600_plan(B)
    name = f"f1600[B={B}" + (f" stride={stride}]" if stride > 1 else "]")
    return dict(name=name, err=err, ms=ms, plain_ms=plain_ms, plain_B=B, bound_ms=b_ms,
                bound_by=by, shape=[200, B], compared="bytes",
                plan=dict(threads_per_lane=nthr, lanes_per_block=lpb,
                          threads_per_block=cuda_keccak.threads_per_block(nthr, lpb)),
                device_fn=lambda: cuda_keccak.f1600(st))


# K2's exponents: the three the paths use, and one with no named chain per
# field (a fixed 256-bit number), run through the sliding window
POW_NAMED = (("fp_inv", P_INT - 2, "p"), ("fp_sqrt", (P_INT + 1) // 4, "p"),
             ("fn_inv", N_INT - 2, "n"))
POW_OTHER = tuple(
    (f"{kind} e=other", int.from_bytes(hashlib.sha256(f"chip smoke {kind}".encode()).digest(),
                                       "big") | (1 << 255), kind)
    for kind in ("p", "n"))
POW_NON_RESIDUE = 3  # no square root mod p: fp_sqrt gives some other value


def check_pow(gen, dev, B, exps=POW_NAMED):
    """K2 on B lanes for each exponent of `exps`, against the plain version
    on limbs. Lanes 0..3 hold 0, 1, m - 1 and 3 (a non-residue mod p). Each
    row gives the step list's squares and multiplies, which its bound counts."""
    out = []
    for tag, e, kind in exps:
        mod = P_INT if kind == "p" else N_INT
        x = rand_scalars(gen, (B,), mod, dev)
        x[:, :4] = torch.from_numpy(f.ints_to_limbs([0, 1, mod - 1, POW_NON_RESIDUE])).to(dev)
        got = cuda_msm.pow_const(x, e, kind)
        lanes = plain_lanes(B, dev)
        xs = x[:, lanes].contiguous()
        want, plain_ms = timed_once(lambda: cuda_msm.pow_const_plain(xs, e, kind))
        err = max_err(got[:, lanes], want)
        assert int(got[:, 0].abs().sum()) == 0, "pow(0) must be 0"
        # the plain version runs the kernel's step list: hold both against
        # an answer that does not come from it
        assert f.limbs_to_ints(want.cpu()) == [pow(v, e, mod) for v in f.limbs_to_ints(xs.cpu())], \
            f"pow_const[{tag}]: the plain version is not x^e"
        ms = time_ms(lambda: cuda_msm.pow_const(x, e, kind))
        chain = f.pow_chain(e)
        mad = (MAD_MUL_P * chain.multiplies + MAD_SQR_P * chain.squares) if kind == "p" else \
            (MAD_MUL_N * chain.multiplies + MAD_SQR_N * chain.squares)
        b_ms, by = bound(2 * 16 * 8 * B, 2 * mad * B)
        out.append(dict(name=f"pow_const[{tag} B={B}]", err=err, ms=ms, plain_ms=plain_ms,
                        plain_B=len(lanes), bound_ms=b_ms, bound_by=by, shape=[16, B],
                        compared="limbs", plan=dict(squares=chain.squares,
                                                    multiplies=chain.multiplies,
                                                    steps=len(chain.steps), slots=chain.slots),
                        device_fn=lambda x=x, e=e, kind=kind: cuda_msm.pow_const(x, e, kind)))
    return out


def add_bytes(ops, outs=3) -> int:
    """Bytes K5a moves: each operand's distinct int64 limbs read once (a
    broadcast operand's one lane once), the outputs written once."""
    return 8 * (sum(c.numel() for c in ops) + outs * 16 * int(np.prod(
        torch.broadcast_shapes(*(c.shape for c in ops))[1:])))


def check_add(name, p, q, plain_reps=3):
    """One K5a row: the wrapper on p + q (any broadcast or strided view)
    against the plain version on limbs, with the plan of its launch. The
    plain version is timed over `plain_reps` calls (one: its checking call)."""
    got = cuda_curve.pt_add(*p, *q)
    want, plain_ms = timed_once(lambda: cuda_curve.pt_add_plain(*p, *q))
    err = max_err(got, want)
    ms = time_ms(lambda: cuda_curve.pt_add(*p, *q))
    if plain_reps > 1:
        plain_ms = time_ms(lambda: cuda_curve.pt_add_plain(*p, *q), reps=plain_reps)
    live = int((~(dc.pt_is_identity(p) | dc.pt_is_identity(q))).sum())
    B = got[0][0].numel()
    b_ms, by = bound(add_bytes(list(p) + list(q)), 2 * MAD_ADD * live)
    T, lpb = cuda_curve.pt_add_plan(B)
    return dict(name=name, err=err, ms=ms, plain_ms=plain_ms, plain_B=B, bound_ms=b_ms,
                bound_by=by, shape=list(got[0].shape), compared="limbs",
                plan=dict(threads_per_lane=T, lanes_per_block=lpb),
                device_fn=lambda: cuda_curve.pt_add(*p, *q))


def special_points(gen, dev, B):
    """(p, q), random points on B lanes but for lanes 0..4: a doubling
    collision, an inverse collision, p the identity, q the identity, both."""
    p = rand_points(gen, (B,), dev)
    q = rand_points(gen, (B,), dev)
    idl = dc.identity((B,), device=dev)
    lane = torch.arange(B, device=dev)
    q = dc.pt_select(lane == 0, p, q)
    q = dc.pt_select(lane == 1, dc.pt_neg(p), q)
    p = dc.pt_select(lane == 2, idl, p)
    q = dc.pt_select(lane == 3, idl, q)
    p = dc.pt_select(lane == 4, idl, p)
    q = dc.pt_select(lane == 4, idl, q)
    return p, q


def check_curve(gen, dev, B):
    p, q = special_points(gen, dev, B)
    add = check_add("pt_add", p, q)
    got = cuda_curve.pt_double(*p)
    want = cuda_curve.pt_double_plain(*p)
    err = max_err(got, want)
    ms = time_ms(lambda: cuda_curve.pt_double(*p))
    plain_ms = time_ms(lambda: cuda_curve.pt_double_plain(*p), reps=3)
    b_ms, by = bound(6 * 16 * 4 * B, 2 * MAD_DBL * B)
    dbl = dict(name="pt_double", err=err, ms=ms, plain_ms=plain_ms, plain_B=B,
               bound_ms=b_ms, bound_by=by, shape=[16, B], compared="limbs",
               device_fn=lambda: cuda_curve.pt_double(*p))
    return [add, dbl]


def check_add_views(gen, dev, B, L=3):
    """K5a on operands the kernel reads in place: one point broadcast over
    B lanes (lane stride 0; lane 0 of p is that point, a doubling), and p
    and q as [:, j] slices of (16, L, B) stacks (limb stride L B)."""
    p = rand_points(gen, (B,), dev)
    one = dc.PointJ(*(c[:, :1] for c in rand_points(gen, (1,), dev)))
    p = dc.pt_select(torch.arange(B, device=dev) == 0, dc.PointJ(*(c.expand(16, B) for c in one)), p)
    rows = [check_add(f"pt_add[broadcast B={B}]", p, one)]
    ps, qs = rand_points(gen, (L, B), dev), rand_points(gen, (L, B), dev)
    j = L // 2
    pj = dc.PointJ(*(c[:, j] for c in ps))
    qj = dc.PointJ(*(c[:, j] for c in qs))
    assert not pj.x.is_contiguous() and cuda_curve.lane_strides(pj.x.shape, pj.x.stride()) == (L * B, 1)
    rows.append(check_add(f"pt_add[strided L={L} B={B}]", pj, qj))
    return rows


# the table build's chain: every double of a generator for window width 8,
# on the u64 table's 49 generators and WNLA-64's 129
CHAIN_N = 255
CHAIN_LANES = (49, 129)


def check_double_chain(gen, dev, B, n=CHAIN_N):
    """K5b as the table build launches it: n successive doubles of B
    generators in one launch, every one against the plain chain (the same
    formula n times) on limbs. Lane 0 holds the identity."""
    p = rand_points(gen, (B,), dev)
    p = dc.pt_select(torch.arange(B, device=dev) == 0, dc.identity((B,), device=dev), p)
    got = cuda_curve.pt_double_chain(*p, n)
    want, plain_ms = timed_once(lambda: cuda_curve.pt_double_chain_plain(*p, n))
    err = max_err(got, want)
    assert bool(dc.pt_is_identity(dc.PointJ(*(c[:, -1] for c in got)))[0]), "doubles of the identity"
    ms = time_ms(lambda: cuda_curve.pt_double_chain(*p, n))
    b_ms, by = bound((3 + 3 * n) * 16 * 4 * B, 2 * MAD_DBL * n * (B - 1))
    return dict(name=f"pt_double[n={n} B={B}]", err=err, ms=ms, plain_ms=plain_ms, plain_B=B,
                bound_ms=b_ms, bound_by=by, shape=[16, n, B], compared="limbs",
                device_fn=lambda: cuda_curve.pt_double_chain(*p, n))


# the table build's rows: NW = 32 windows of 2^8 entries for each of the
# u64 table's 49 generators and WNLA-64's 129
AFFINE_SHAPES = ((32 * 49, 256), (32 * 129, 256))


def check_affine_rows(gen, dev, M, NE):
    """The table build's affine step on M rows of NE Jacobian points, the
    first entry of each row and a few others the identity, as a table's
    are, against the plain product tree on limbs."""
    p = rand_points(gen, (M, NE), dev)
    dead = torch.zeros((M, NE), dtype=torch.bool, device=dev)
    dead[:, 0] = True
    dead[M // 2] = True  # a row of identities only
    dead[M - 1, NE - 1] = True
    p = dc.pt_select(dead, dc.identity((M, NE), device=dev), p)
    got = cuda_curve.affine_rows(*p)
    want, plain_ms = timed_once(lambda: cuda_curve.affine_rows_plain(*p))
    err = max_err(got, want)
    ms = time_ms(lambda: cuda_curve.affine_rows(*p))
    # per live entry 6 multiplies and a square; per row with a live entry one
    # inversion (78 multiplies, 252 squares)
    live = int((~dead).sum())
    rows = int((~dead).any(dim=1).sum())
    mads = live * (6 * MAD_MUL_P + MAD_SQR_P) + rows * (78 * MAD_MUL_P + 252 * MAD_SQR_P)
    b_ms, by = bound(5 * 16 * 4 * M * NE, 2 * mads)
    return dict(name=f"affine_rows[M={M} NE={NE}]", err=err, ms=ms, plain_ms=plain_ms,
                plain_B=M, bound_ms=b_ms, bound_by=by, shape=[16, M, NE], compared="limbs",
                device_fn=lambda: cuda_curve.affine_rows(*p))


def check_fixed(gen, dev, B, tables, tag):
    F = tables.n_points
    sc = rand_scalars(gen, (F, B), N_INT, dev)
    sc[:, :, 0] = 0  # all-zero scalars: the identity
    sc[:, 1:, 1] = 0  # one live generator
    got = dc.PointJ(*cuda_fixed_base.fixed_msm(tables, sc))
    lanes = plain_lanes(B, dev)
    scs = sc[:, :, lanes].contiguous()
    want, plain_ms = timed_once(lambda: cuda_fixed_base.fixed_msm_plain(tables, scs))
    err = max_err(dc.compress(got)[:, lanes], dc.compress(dc.PointJ(*want)))
    assert bool(dc.pt_is_identity(got)[0]), "zero scalars must give the identity"
    ms = time_ms(lambda: cuda_fixed_base.fixed_msm(tables, sc))
    live = int((cuda_fixed_base._digits(sc, tables.w_bits) != 0).sum())
    # the table rows the call walks (a row view reads F of the table's rows)
    row_bytes = tables.n_windows * (1 << tables.w_bits) * 64
    nbytes = row_bytes * F + (16 * F + 3 * 16) * 4 * B
    b_ms, by = bound(nbytes, 2 * MAD_MIXED * live)
    if tables.rows is not None:
        tag += " rows"
    return dict(name=f"fixed_msm[{tag}]", err=err, ms=ms, plain_ms=plain_ms, plain_B=len(lanes),
                bound_ms=b_ms, bound_by=by, shape=[16, F, B], w_bits=tables.w_bits,
                plan=dict(slices=cuda_fixed_base.slice_count(B, F, tables.n_windows)),
                compared="compressed bytes (kernel adds are incomplete, plain adds complete)",
                device_fn=lambda: cuda_fixed_base.fixed_msm(tables, sc))


def check_msm_small(gen, dev, B, D, kernel="msm_small_wnaf"):
    """One of the three small-MSM kernels (K4, K8 or K9, by wrapper name)
    at D points per lane against its plain version, on compressed bytes.
    Lane 0 has zero scalars, lane 1 identity points, lane 2 the scalar
    lambda on every point (GLV halves k1 = 0, k2 = 1), lane 3 the scalar 5
    (k2 = 0), lane 4 an identity first point, lane 5 the scalar n - 1: the
    threads of one lane (K4, K8, K9) then hand the join identities and
    negated halves."""
    pts = rand_points(gen, (D, B), dev)
    kk = rand_scalars(gen, (D, B), N_INT, dev)
    kk[:, :, 0] = 0  # zero scalars
    kk[:, :, 2] = torch.from_numpy(f.int_to_limbs(glv.LAMBDA)).to(dev)
    kk[:, :, 3] = torch.from_numpy(f.int_to_limbs(5)).to(dev)
    kk[:, :, 5] = torch.from_numpy(f.int_to_limbs(N_INT - 1)).to(dev)
    idl = dc.identity((D, B), device=dev)
    lane = torch.arange(B, device=dev)[None]
    point = torch.arange(D, device=dev)[:, None]
    pts = dc.pt_select((lane == 1) | ((lane == 4) & (point == 0)), idl, pts)
    coords = [c.movedim(1, 0).contiguous() for c in pts]  # (D, 16, B)
    if kernel == "msm_small":
        ins = [kk.movedim(1, 0).contiguous()]
    elif kernel == "msm_small_glv":
        ins = list(glv.glv_halves(kk))
    else:
        ins = [glv.wnaf_planes(kk)]
    wrapper = getattr(cuda_msm, kernel)
    plain = getattr(cuda_msm, f"{kernel}_plain")
    got = dc.PointJ(*wrapper(*coords, *ins))
    lanes = plain_lanes(B, dev)
    small = [c[..., lanes].contiguous() for c in coords + ins]
    want, plain_ms = timed_once(lambda: plain(*small))
    err = max_err(dc.compress(got)[:, lanes], dc.compress(dc.PointJ(*want)))
    assert bool(dc.pt_is_identity(got)[:2].all()), "zero scalars / identity points"
    ms = time_ms(lambda: wrapper(*coords, *ins))
    # work this run's data needs: the doubles of the walk (K8, K9: none
    # before the first window) and the table builds on every lane, one add
    # per nonzero digit, one beta multiply per nonzero odd GLV half (K8) or
    # per nonzero digit of one (K4)
    table = D * (MAD_DBL + 13 * MAD_ADD)
    if kernel == "msm_small":
        digits = torch.stack([(kk[w // 4] >> (4 * (w % 4))) & 15 for w in range(64)])
        mads = (4 * 63 * MAD_DBL + table) * B + MAD_ADD * int((digits != 0).sum())
        nbytes = (4 * D + 3) * 16 * 4 * B
    elif kernel == "msm_small_glv":
        mags = ins[0].movedim(0, 1)  # (16, 2D, B)
        digits = torch.stack([(mags[w // 4] >> (4 * (w % 4))) & 15 for w in range(glv.GLV_WINDOWS)])
        live = int((digits != 0).sum())
        phi = int((mags[:, 1::2] != 0).any(dim=0).sum())
        mads = (4 * (glv.GLV_WINDOWS - 1) * MAD_DBL + table) * B + MAD_ADD * live \
            + MAD_MUL_P * phi
        nbytes = ((5 * D + 3) * 16 + 2 * D) * 4 * B
    else:
        dig = ins[0]
        live = int(((dig & 15) != 0).sum())
        phi = int(((dig.reshape(glv.GLV_WINDOWS, D, 2, B)[:, :, 1] & 15) != 0).sum())
        mads = (4 * glv.GLV_WINDOWS * MAD_DBL + D * (MAD_DBL + 6 * MAD_ADD)) * B \
            + MAD_ADD * live + MAD_MUL_P * phi
        nbytes = ((3 * D + 3) * 16 + glv.GLV_WINDOWS * 2 * D) * 4 * B
    b_ms, by = bound(nbytes, 2 * mads)
    plan = getattr(cuda_msm, f"{kernel}_plan")(D, B)
    plan = dict(zip(("threads_per_lane", "lanes_per_block"), plan))
    return dict(name=f"{kernel}[D={D}]", err=err, ms=ms, plain_ms=plain_ms, plan=plan,
                plain_B=len(lanes), bound_ms=b_ms, bound_by=by, shape=[D, 16, B],
                compared="compressed bytes (kernel adds are incomplete, plain adds complete)",
                device_fn=lambda: wrapper(*coords, *ins))


# K6's edge lanes: (lane, scalar) — k = 0, 1, n - 1, a small scalar, lambda
# (k1 = 0), 1 + lambda, n - lambda (a negative k2), 5 (k2 = 0), 2^128 + 1,
# and two scalars at or above n (n + 5, 2^256 - 1), which the kernel reduces
# once and the plain ladder walks as they are; lane 3 holds the identity point
K6_EDGE = ((0, 0), (1, 1), (2, N_INT - 1), (4, 0x1F), (5, glv.LAMBDA), (6, 1 + glv.LAMBDA),
           (7, N_INT - glv.LAMBDA), (8, 5), (9, (1 << 128) + 1), (10, N_INT + 5),
           (11, (1 << 256) - 1))


def k6_bound(P, k):
    """The least time of the GLV walk's work on these inputs: per lane with
    a live point and a nonzero scalar, the table [1..15] P (1 double, 13
    adds), 4 doubles per window below the top nonzero window of the larger
    half, one add per nonzero digit of either half, beta's multiply for a
    nonzero k2 and the join of two nonzero halves."""
    B = k.shape[-1]
    # k below 2^256 < 2n reduced once, as the kernel does
    m1, _, m2, _ = glv.decompose(f.fn_add(k, torch.zeros_like(k)))
    dig = [torch.stack([(m[w // 4] >> (4 * (w % 4))) & 15 for w in range(glv.GLV_WINDOWS)])
           for m in (m1, m2)]  # (33, B) each
    nz = torch.stack(dig) != 0  # (2, 33, B)
    any_nz = nz.any(dim=0)
    live = ~dc.pt_is_identity(P) & any_nz.any(dim=0)
    wins = torch.arange(glv.GLV_WINDOWS, device=k.device)[:, None]
    top = torch.where(any_nz, wins, 0).max(dim=0).values
    halves = nz.any(dim=1)  # (2, B)
    mads = (MAD_DBL + 13 * MAD_ADD + 4 * MAD_DBL * top + MAD_ADD * nz.sum(dim=(0, 1))
            + MAD_MUL_P * halves[1] + MAD_ADD * (halves[0] & halves[1]))
    return bound(7 * 16 * 4 * B, 2 * int(mads[live].sum()))


def check_scalar_mul(gen, dev, sizes):
    """K6 at each lane count of `sizes`, each launch on the leading lanes of
    one set of inputs, against ONE call of the plain version on the plain
    lanes of every launch: the eager ladder is bound by its launches and
    costs about as much for a thousand lanes as for 64. The kernel walks
    GLV halves with incomplete adds where the plain ladder uses complete
    ones: compared as points. -> one row per size."""
    top = max(sizes)
    p = rand_points(gen, (top,), dev)
    k = rand_scalars(gen, (top,), N_INT, dev)
    for lane, val in K6_EDGE:
        k[:, lane] = torch.from_numpy(f.int_to_limbs(val))[:, 0].to(dev)
    p = dc.pt_select(torch.arange(top, device=dev) == 3, dc.identity((top,), device=dev), p)

    def inputs(B):
        return [c[:, :B].contiguous() for c in p] + [k[:, :B].contiguous()]

    got_lanes, picks = [], []
    for B in sizes:
        ins = inputs(B)
        got = cuda_ladder.scalar_mul(*ins)
        out = dc.PointJ(*got)
        assert dc.pt_is_identity(out)[[0, 3]].all(), "k = 0 and P = identity must give the identity"
        assert bool(dc.pt_eq(out, dc.PointJ(*ins[:3]))[1]), "k = 1 must give P"
        assert bool(dc.pt_eq(out, dc.pt_neg(dc.PointJ(*ins[:3])))[2]), "k = n - 1 must give -P"
        lanes = plain_lanes(B, dev)
        got_lanes.append(dc.compress(out)[:, lanes])
        picks.append(lanes)
    idx = torch.cat(picks)
    small = [c[:, idx].contiguous() for c in p] + [k[:, idx].contiguous()]
    want, plain_ms = timed_once(lambda: cuda_ladder.scalar_mul_plain(*small))
    want = dc.compress(dc.PointJ(*want))
    rows, off = [], 0
    for B, got, lanes in zip(sizes, got_lanes, picks):
        err = max_err(got, want[:, off:off + len(lanes)])
        off += len(lanes)
        ins = inputs(B)
        ms = time_ms(lambda: cuda_ladder.scalar_mul(*ins))
        b_ms, by = k6_bound(dc.PointJ(*ins[:3]), ins[3])
        plan = dict(zip(("threads_per_lane", "lanes_per_block"), cuda_ladder.scalar_mul_plan(B)))
        rows.append(dict(name=f"scalar_mul[B={B}]", err=err, ms=ms, plain_ms=plain_ms, plan=plan,
                         plain_B=len(idx), bound_ms=b_ms, bound_by=by, shape=[16, B],
                         compared="compressed bytes (one plain call over the plain lanes of "
                                  "every size; kernel adds are incomplete, plain adds complete)",
                         device_fn=lambda ins=ins: cuda_ladder.scalar_mul(*ins)))
    return rows


def tree_points(gen, dev, L, B, n, strided=False):
    """K7's inputs: (16, L, B) random points (if `strided`, a view of a
    (16, B, L) stack, which the kernel reads in place) with these
    lanes: 0 all identities; 1, 2, 3 an identity first, last and middle
    point; 4 its points 0 and 1 negatives of each other (a run that sums
    to the identity); 5 every slot that is as long as slot 0 under n
    slots (two points or more) a copy of slot 0's points, so the join meets
    equal partials (a doubling). -> (points, mask of the identity points)."""
    p = rand_points(gen, (L, B), dev)
    lane = torch.arange(B, device=dev)[None]
    row = torch.arange(L, device=dev)[:, None]
    dead = (lane == 0) | ((lane == 1) & (row == 0)) | ((lane == 2) & (row == L - 1)) \
        | ((lane == 3) & (row == L // 2))
    p = dc.pt_select(dead, dc.identity((L, B), device=dev), p)
    if B > 4 and L > 1:
        for c, v in zip(p, dc.pt_neg(dc.PointJ(*(c[:, 0, 4] for c in p)))):
            c[:, 1, 4] = v
    bounds = cuda_ladder.slot_bounds(L, n)
    lo0, hi0 = bounds[0]
    if B > 5 and hi0 - lo0 >= 2:  # a doubling inside a slot would need a dlog relation
        for lo, hi in bounds[1:]:
            if hi - lo == hi0 - lo0:
                for c in p:
                    c[:, lo:hi, 5] = c[:, lo0:hi0, 5]
    if strided:
        p = dc.PointJ(*(c.transpose(1, 2).contiguous().transpose(1, 2) for c in p))
    return p, dead


def check_tree_sum(gen, dev, L, B, strided=False):
    """K7 on B lanes of L points (`tree_points`), in limbs against the plain
    mirror of its own order under its plan (`tree_sum_slots_plain`), and
    in compressed bytes against the plain sequential chain and the
    pairwise reduction with complete adds; on every lane while L B is at
    most the u64 mirror's 17 x 1024, else on the plain lanes."""
    n, lpb = cuda_ladder.tree_sum_plan(L, B)
    p, dead = tree_points(gen, dev, L, B, n, strided)
    got = cuda_ladder.tree_sum(*p)
    assert bool(dc.pt_is_identity(dc.PointJ(*got))[0]), "a sum of identities is the identity"
    lanes = torch.arange(B, device=dev) if L * B <= 17 * BATCH else plain_lanes(B, dev)
    small = [c[..., lanes] for c in p]
    want, plain_ms = timed_once(lambda: cuda_ladder.tree_sum_plain(*small))
    got_l = dc.PointJ(*(c[:, lanes] for c in got))
    err = max_err(got_l, cuda_ladder.tree_sum_slots_plain(*small, n))
    for ref in (want, cuda_curve.tree_sum_plain(*small)):
        err = max(err, max_err(dc.compress(got_l), dc.compress(dc.PointJ(*ref))))
    ms = time_ms(lambda: cuda_ladder.tree_sum(*p))
    live_adds = int((~dead).sum()) - int((~dead).any(dim=0).sum())
    # int64 limbs: L points in, one out, per lane
    b_ms, by = bound((3 * L + 3) * 16 * 8 * B, 2 * MAD_ADD * live_adds)
    name = f"tree_sum[L={L} B={B}" + (" strided]" if strided else "]")
    return dict(name=name, err=err, ms=ms, plain_ms=plain_ms, plain_B=len(lanes),
                bound_ms=b_ms, bound_by=by, shape=[16, L, B],
                plan=dict(slots_per_lane=n, lanes_per_block=lpb),
                compared="limbs against the plain mirror of the kernel's order "
                         "(tree_sum_slots_plain), compressed bytes against the chained "
                         "incomplete adds and the pairwise complete reduction",
                device_fn=lambda: cuda_ladder.tree_sum(*p))


def round0_r_positions():
    """The table rows the fast WNLA prover's first-round R commitment walks
    at the u64 dims: g, the odd positions of the 26 live h entries and the
    odd positions of g_vec."""
    lh, lg, zh = 32, 16, 6
    return (0,) + tuple(1 + 2 * j + 1 for j in range((lh - zh) // 2)) \
        + tuple(1 + lh + 2 * j + 1 for j in range(lg // 2))


# -- what the paths give K3, K5a, K6 and K7 -------------------------------------------

# the shapes the kernels phase holds K6 and K7 at with or without a record:
# the u64 mirror verifier's P_t ladder (17 points) and first generator fold
# (32), and its sum over 17 points of 1024 lanes
SCALAR_MUL_LANES = (17 * BATCH, 32 * BATCH)
TREE_SUM_SHAPES = ((17, BATCH),)
# K1 at the verifier's two batches
KECCAK_LANES = (BATCH, BIG_BATCH)
# and K5a at the u64 table build's last add (32 windows x 49 generators x
# 128 entries), under the launch with 2 threads per lane
ADD_LANES = (32 * 49 * 128,)


def new_shape_log() -> dict:
    return {"scalar_mul": set(), "tree_sum": set(), "fixed_msm": {}, "pt_add": set(),
            "f1600": set(), "pt_double": set(), "table_builds": [], "timed_calls": []}


@contextlib.contextmanager
def recording_shapes(log: dict, where: str):
    """For the block, note what each launch of K1, K3, K5a, K5b, K6 and K7
    is given, so the kernels phase holds each of them at every shape a path
    gave it: K1's, K5a's and K6's lane counts, K5b's (lane count, doubles)
    pairs, K7's (point count L, lane count) pairs, and every table or row
    subset K3 walked (by identity, with the phase `where` it was first met
    in)."""
    orig = (cuda_ladder.scalar_mul, cuda_ladder.tree_sum, cuda_fixed_base.fixed_msm,
            cuda_curve.pt_add, cuda_keccak.f1600, cuda_curve.pt_double, cuda_curve.pt_double_chain)

    def scalar_mul(px, py, pz, k):
        log["scalar_mul"].add(torch.broadcast_shapes(px.shape, k.shape)[1:].numel())
        return orig[0](px, py, pz, k)

    def tree_sum(x, y, z):
        log["tree_sum"].add((x.shape[1], x.shape[2:].numel()))
        return orig[1](x, y, z)

    def fixed_msm(tab, scalars):
        log["fixed_msm"].setdefault(id(tab), (tab, where))
        return orig[2](tab, scalars)

    def pt_add(*ops):
        log["pt_add"].add(torch.broadcast_shapes(*(c.shape for c in ops))[1:].numel())
        return orig[3](*ops)

    def f1600(state):
        log["f1600"].add(state.shape[1:].numel())
        return orig[4](state)

    def pt_double(X, Y, Z):
        log["pt_double"].add((X.shape[1:].numel(), 1))
        return orig[5](X, Y, Z)

    def pt_double_chain(X, Y, Z, n):
        log["pt_double"].add((X.shape[1:].numel(), n))
        return orig[6](X, Y, Z, n)

    (cuda_ladder.scalar_mul, cuda_ladder.tree_sum, cuda_fixed_base.fixed_msm,
     cuda_curve.pt_add, cuda_keccak.f1600, cuda_curve.pt_double, cuda_curve.pt_double_chain) = (
        scalar_mul, tree_sum, fixed_msm, pt_add, f1600, pt_double, pt_double_chain)
    try:
        yield log
    finally:
        (cuda_ladder.scalar_mul, cuda_ladder.tree_sum, cuda_fixed_base.fixed_msm,
         cuda_curve.pt_add, cuda_keccak.f1600, cuda_curve.pt_double,
         cuda_curve.pt_double_chain) = orig


def shape_plan(log, known_tables=()):
    """What the kernels phase holds K6, K7 and K3 at: the fixed shapes and
    every one in `log`. -> (K6 lane counts, K7 (point count, lane count)
    pairs, [(tables, where)] of the recorded tables not in `known_tables`)."""
    log = log or new_shape_log()
    known = {id(t) for t in known_tables}
    return (sorted(set(SCALAR_MUL_LANES) | log["scalar_mul"]),
            sorted(set(TREE_SUM_SHAPES) | log["tree_sum"]),
            [tw for key, tw in log["fixed_msm"].items() if key not in known])


def keccak_lanes_plan(log):
    """The lane counts the kernels phase holds K1 at: KECCAK_LANES and every
    count in `log` (each transcript's batch on the paths)."""
    return sorted(set(KECCAK_LANES) | (log or new_shape_log())["f1600"])


def add_lanes_plan(log):
    """The lane counts the kernels phase holds K5a at beside its 1024-lane
    rows: ADD_LANES and every count in `log` (the paths' adds and the
    table builds', up to 528,384 lanes for WNLA-64's 129 generators)."""
    return sorted((set(ADD_LANES) | (log or new_shape_log())["pt_add"]) - {BATCH})


def table_build_plan(log):
    """What the kernels phase holds K5b and the table build's affine step
    at: the fixed shapes, every one that the table builds in `log` (each as
    `timing_table_builds` notes it) gave them, and K5b's other launches on
    the paths (Pippenger's window doubles, the Straus MSMs' doubles). ->
    (K5b chain (lanes, doubles), affine_rows (rows, entries))."""
    log = log or new_shape_log()
    builds = log["table_builds"]
    return (sorted({(F, CHAIN_N) for F in CHAIN_LANES} | set(log.get("pt_double", ()))
                   | {tuple(s) for b in builds for s in b["chain"]}),
            sorted(set(AFFINE_SHAPES) | {tuple(s) for b in builds for s in b["affine"]}))


def phase_kernels(dev, tables, launches=None, shapes=None):
    """Every kernel against its plain version on the card. `launches`: the
    main path's counts, reported beside each kernel when given; `shapes`:
    the log of `recording_shapes` over the paths, whose K3, K5a, K6 and K7
    shapes get rows too, with the fixtures' table builds, whose K5b chain
    and affine_rows shapes get rows too."""
    gen = np.random.default_rng(2024)
    launches = launches or {}
    rows = []
    # the main path's shapes at a batch of 1024, and a ragged batch that is
    # no multiple of the block size
    # K1 at every lane count a path gave it (the verifiers' 1024 and 16384)
    for B in keccak_lanes_plan(shapes):
        rows.append(check_keccak(gen, dev, B))
    for B in (14 * BATCH, BATCH):
        rows += check_pow(gen, dev, B)
    rows += check_pow(gen, dev, BATCH, POW_OTHER)
    rows += check_curve(gen, dev, BATCH)
    rows += check_add_views(gen, dev, BATCH)
    rows.append(check_fixed(gen, dev, BATCH, tables["full"], "F=49"))
    rows.append(check_fixed(gen, dev, BATCH, tables["gv"], "F=17"))
    r_rows = tables["full"].subset(round0_r_positions())
    rows.append(check_fixed(gen, dev, BATCH, r_rows, f"F={r_rows.n_points} prover R"))
    k6_lanes, k7_shapes, k3_tables = shape_plan(
        shapes, (tables["full"], tables["gv"], r_rows))
    # the table build's doubling chain and affine step at every shape a
    # build gave them (the u64 table's 49 generators, WNLA's 33 / 65 / 129)
    chains, affine = table_build_plan(shapes)
    for F, n in chains:
        rows.append(check_double_chain(gen, dev, F, n))
    for M, NE in affine:
        rows.append(check_affine_rows(gen, dev, M, NE))
    # every other table or row subset a path walked: the u64 prover's other
    # subsets, the standalone WNLA's tables over 1 + 2 sz rows and subsets
    for i, (tab, where) in enumerate(k3_tables):
        rows.append(check_fixed(gen, dev, BATCH, tab, f"F={tab.n_points} {where} #{i}"))
    # the largest whole table (WNLA-64's 129 rows after a full run) read
    # through a row index of all its rows in reverse order
    whole = [t for t, _ in k3_tables if t.rows is None] + [tables["full"]]
    big = max(whole, key=lambda t: t.n_points)
    rows.append(check_fixed(gen, dev, BATCH, big.take(list(range(big.n_points))[::-1]),
                            f"F={big.n_points} reversed"))
    # a batch that fills the card: the wrappers choose coarser splits there
    rows.append(check_fixed(gen, dev, BIG_BATCH, tables["full"], f"F=49 B={BIG_BATCH}"))
    for D in (2, cuda_msm.DMAX):
        rows.append(check_msm_small(gen, dev, BIG_BATCH, D))
        rows[-1]["name"] += f" B={BIG_BATCH}"
    # every point count the small MSM is built for, so each instantiation a
    # path can reach (verify: D = 2, 5; mirror: also 4 and 1; prove: 2) is held
    # against the plain version at the batch's lanes
    for D in range(1, cuda_msm.DMAX + 1):
        rows.append(check_msm_small(gen, dev, BATCH, D))
    # K8 and K9 at every point count they are built for (the variant paths
    # reach D = 1, 2 and 3)
    for kernel in ("msm_small_glv", "msm_small"):
        for D in range(1, cuda_msm.DMAX_U4 + 1):
            rows.append(check_msm_small(gen, dev, BATCH, D, kernel))
        # a batch that fills the card, under whichever launch the plan takes there
        rows.append(check_msm_small(gen, dev, BIG_BATCH, cuda_msm.DMAX_U4, kernel))
        rows[-1]["name"] += f" B={BIG_BATCH}"
    # the ladder at every lane count a path gave it (the mirror verifiers'
    # ladders and folds, the WNLA commitment over 1 + 2 sz points per lane),
    # the sum at every (point count, lane count) pair (the u64 mirror's 17
    # points, the WNLA commitments' 33 / 65 / 129, the prover's grouped sums)
    rows += check_scalar_mul(gen, dev, k6_lanes)
    for L, B in k7_shapes:
        rows.append(check_tree_sum(gen, dev, L, B))
    # K5a at every lane count a path or a table build gave it, so both of
    # its launches (4 threads per lane up to 8,192 lanes, 2 beyond) meet the
    # five special lanes at the paths' shapes
    for B in add_lanes_plan(shapes):
        rows.append(check_add(f"pt_add[B={B}]", *special_points(gen, dev, B), plain_reps=1))
    ragged = [check_keccak(gen, dev, 77), check_keccak(gen, dev, BATCH, stride=2)]
    ragged += check_pow(gen, dev, 333)
    ragged += check_curve(gen, dev, 201)
    ragged.append(check_double_chain(gen, dev, 37))
    ragged.append(check_affine_rows(gen, dev, 37, 16))
    ragged.append(check_fixed(gen, dev, 67, tables["gv"], "F=17"))
    ragged.append(check_msm_small(gen, dev, 70, 3))
    ragged.append(check_msm_small(gen, dev, 77, 2))
    ragged.append(check_msm_small(gen, dev, 333, cuda_msm.DMAX))
    ragged.append(check_msm_small(gen, dev, 70, 3, "msm_small_glv"))
    ragged.append(check_msm_small(gen, dev, 77, 2, "msm_small_glv"))
    ragged.append(check_msm_small(gen, dev, 70, 3, "msm_small"))
    ragged.append(check_msm_small(gen, dev, 77, 2, "msm_small"))
    ragged += check_scalar_mul(gen, dev, [203])
    ragged.append(check_tree_sum(gen, dev, 7, 93))
    ragged.append(check_tree_sum(gen, dev, 7, 93, strided=True))
    # K5a's 2-thread launch on a batch that is no multiple of its block
    ragged.append(check_add("pt_add[B=12345]", *special_points(gen, dev, 12345), plain_reps=1))
    for r in ragged:
        r["name"] += " ragged"
    rows += ragged
    torch.cuda.synchronize()
    # the paths' own calls timed on the card in the same profiler session
    # (Pippenger's and ladder + sum's): one session per process records
    # reliably, a second one did not
    measure_device(rows + (shapes or {}).get("timed_calls", []))
    bad = [r["name"] for r in rows if r["err"] != 0]
    emit("kernels", ok=not bad, kernels=[
        dict(name=r["name"], shape=r["shape"], ok=r["err"] == 0, max_abs_err=r["err"],
             kernel_ms=r["ms"], device_ms=r.get("device_ms"), plain_ms=r["plain_ms"],
             plain_B=r["plain_B"], plan=r.get("plan"),
             launches=launches.get(kernel_of(r["name"])),
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], compared=r["compared"])
        for r in rows])
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return rows


# -- phase: verify ------------------------------------------------------------------


@contextlib.contextmanager
def timing_table_builds(log: list):
    """For the block, time each fixed-base table build (a fixture's
    set-up), count its K5b and affine_rows launches and note the shapes it
    gave them: appends {points, w_bits, seconds, pt_double_launches,
    affine_rows_launches, chain: [[lanes, doubles]], affine: [[rows,
    entries]]} to `log` per build."""
    from bppp_tpu_torch.ops import fixed_base
    from bppp_tpu_torch.protocol import u64 as pu64

    orig = cuda_fixed_base.build_tables
    orig_curve = cuda_curve.pt_double_chain, cuda_curve.affine_rows
    given = {"chain": [], "affine": []}

    def pt_double_chain(X, Y, Z, n):
        given["chain"].append([X.shape[1:].numel(), n])
        return orig_curve[0](X, Y, Z, n)

    def affine_rows(X, Y, Z):
        given["affine"].append(list(X.shape[1:]))
        return orig_curve[1](X, Y, Z)

    def build_tables(points, w_bits=cuda_fixed_base.DEFAULT_W):
        for v in given.values():
            v.clear()
        torch.cuda.synchronize()
        before = dict(cuda_curve.LAUNCHES)
        t0 = time.perf_counter()
        tab = orig(points, w_bits)
        torch.cuda.synchronize()
        log.append(dict(points=int(points.x.shape[1]), w_bits=w_bits,
                        seconds=time.perf_counter() - t0,
                        **{f"{k}_launches": cuda_curve.LAUNCHES[k] - before[k]
                           for k in ("pt_double", "affine_rows")},
                        **{k: list(v) for k, v in given.items()}))
        return tab

    mods = (cuda_fixed_base, fixed_base, pu64)
    for m in mods:
        m.build_tables = build_tables
    cuda_curve.pt_double_chain, cuda_curve.affine_rows = pt_double_chain, affine_rows
    try:
        yield log
    finally:
        for m in mods:
            m.build_tables = orig
        cuda_curve.pt_double_chain, cuda_curve.affine_rows = orig_curve


def fail_on_table_builds(where: str, builds: list) -> None:
    """Each table build launches the doubling chain once and affine_rows once."""
    bad = [b for b in builds if b["pt_double_launches"] != 1 or b["affine_rows_launches"] != 1]
    if not builds or bad:
        raise SystemExit(f"{where}: table builds {builds} must launch pt_double and "
                         "affine_rows once each")


def oracle_proofs(public, rng):
    """Oracle proofs of four values, each checked by the oracle's verifier.
    -> (commitments, proofs)."""
    xs = [0, 123456, 0xDEADBEEFCAFEBABE, 2**64 - 1]
    coms, proofs = [], []
    for x in xs:
        s = rng.scalar()
        com = public.commit_value(x, s)
        proof = public.prove(x, s, HostTranscript(LABEL), rng)
        assert public.verify(com, proof, HostTranscript(LABEL)), "oracle rejects its own proof"
        coms.append(com)
        proofs.append(proof)
    return coms, proofs


def make_batch(public, distinct, B, dev):
    """The oracle proofs of four values (`distinct`: (commitments, proofs)
    from `oracle_proofs`) tiled over B lanes, with a few lanes tampered
    (`wire_blobs` does the same to wire blobs). -> (commitment bytes,
    proof, expected mask, oracle report)."""
    coms, proofs = distinct
    pb4 = cv.reciprocal_proofs_to_bytes(proofs, device="cpu")
    cb4 = torch.from_numpy(cv.point_bytes(coms))
    reps = -(-B // 4)
    tile = lambda a: a.repeat((1,) * (a.ndim - 1) + (reps,))[..., :B].contiguous()
    cb = tile(cb4)
    r = tile(pb4.r)
    c_s = tile(pb4.circuit.c_s)
    wl = tile(pb4.circuit.wnla.l)
    wn = tile(pb4.circuit.wnla.n)
    wx = tile(pb4.circuit.wnla.x)
    want = torch.ones(B, dtype=torch.bool)

    def reject(lane):
        want[lane] = False

    r[5, 4] ^= 0x40  # a point byte of the poles commitment
    reject(4)
    wl[0, 0, 5] = (wl[0, 0, 5] + 1) % (1 << 16)  # the final scalar
    reject(5)
    cb[:, 6] = cb4[:, 3]  # wrong commitment (lane 6 holds the proof of xs[2])
    reject(6)
    c_s[0, 7] = 7  # bad SEC1 tag
    reject(7)
    bad = N_INT + 5  # scalar >= n
    for i in range(16):
        wn[i, 0, 8] = (bad >> (16 * i)) & 0xFFFF
    reject(8)
    wx[3, 2, 9] ^= 0x11  # middle-round X point
    reject(9)
    r[1:, 10] = 0xFF  # x >= p
    r[0, 10] = 2
    reject(10)

    # the oracle on the tampered proofs it can represent
    import copy

    p5 = copy.deepcopy(proofs[5 % 4])
    p5.circuit_proof.l[0] = (p5.circuit_proof.l[0] + 1) % N_INT
    oracle = dict(
        valid=[True] * 4,
        tampered_scalar=public.verify(coms[5 % 4], p5, HostTranscript(LABEL)),
        wrong_commitment=public.verify(coms[3], proofs[6 % 4], HostTranscript(LABEL)),
    )
    assert oracle["tampered_scalar"] is False and oracle["wrong_commitment"] is False

    circuit = pb4.circuit._replace(
        c_l=tile(pb4.circuit.c_l), c_r=tile(pb4.circuit.c_r), c_o=tile(pb4.circuit.c_o),
        c_s=c_s,
        wnla=pb4.circuit.wnla._replace(r=tile(pb4.circuit.wnla.r), x=wx, l=wl, n=wn),
    )
    pb = cv.from_reference(type(pb4)(circuit=circuit, r=r), device=dev)
    return cb.to(dev), pb, want, oracle


def path_counts(path: str):
    """After a path's run: (launches, kernels of the path never launched,
    plain versions that were called)."""
    launches, plain = read_counts()
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    return launches, missing, {k: n for k, n in plain.items() if n}


def count_faults(path: str, launches, missing, plain_used) -> list:
    """What is wrong with a path's counts: kernels of the path never
    launched, kernels it must not launch launched, plain versions called."""
    faults = []
    if missing:
        faults.append(f"kernels never launched on the {path} path: {missing}")
    banned = [k for k in PATH_BANNED.get(path, ()) if launches[k]]
    if banned:
        faults.append(f"kernels launched on the {path} path that it must not launch: {banned}")
    if plain_used:
        faults.append(f"plain versions ran on the {path} path: {plain_used}")
    return faults


def fail_on_counts(path: str, launches, missing, plain_used) -> None:
    faults = count_faults(path, launches, missing, plain_used)
    if faults:
        raise SystemExit("; ".join(faults))


def run_verify(dobj, cb, pb, fast: bool):
    B = cb.shape[-1]
    return dobj.verify(cb, Transcript(LABEL, batch=(B,), device=cb.device), pb, fast=fast)


def phase_verify(dev):
    """-> (launches of the path, what the later phases share: the oracle
    instance, the device instance, the rng, the batch and its expected and
    observed masks)."""
    reset_counts()
    t0 = time.time()
    builds = []
    with timing_table_builds(builds):
        public, device_obj, rng = u64_fixture(SEED, BATCH, device=dev, tables="auto")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    distinct = oracle_proofs(public, rng)
    cb, pb, want, oracle = make_batch(public, distinct, BATCH, dev)

    ok = run_verify(device_obj, cb, pb, fast=True)
    torch.cuda.synchronize()
    launches, missing, plain_used = path_counts("verify")
    got = ok.cpu()
    assert got.dtype == torch.bool and tuple(got.shape) == (BATCH,)
    wrong = torch.nonzero(got != want).flatten().tolist()

    ms_1k = time_ms(lambda: run_verify(device_obj, cb, pb, fast=True), reps=5)
    reps = BIG_BATCH // BATCH
    tile = lambda a: a.repeat((1,) * (a.ndim - 1) + (reps,)).contiguous()
    big_obj = type(device_obj)(
        g=dc.PointJ(*(tile(c) for c in device_obj.g)),
        g_vec=dc.PointJ(*(tile(c) for c in device_obj.g_vec)),
        h_vec=dc.PointJ(*(tile(c) for c in device_obj.h_vec)),
        tables=device_obj.tables,
    )
    cb_big = tile(cb)
    pb_big = map_tensors(pb, tile)
    ok_big = run_verify(big_obj, cb_big, pb_big, fast=True)
    torch.cuda.synchronize()
    big_wrong = int((ok_big.cpu() != want.repeat(reps)).sum())
    ms_16k = time_ms(lambda: run_verify(big_obj, cb_big, pb_big, fast=True), reps=3)

    emit(
        "verify", ok=not wrong and not missing and not plain_used and big_wrong == 0,
        batch=BATCH, accepted=int(got.sum()), rejected_lanes=torch.nonzero(~got).flatten().tolist(),
        wrong_lanes=wrong, oracle=oracle, launches=launches, plain_calls=plain_used,
        fixture_seconds=setup_s, table_builds=builds,
        ms_per_batch_1024=ms_1k, verifies_per_s_1024=BATCH / ms_1k * 1e3,
        ms_per_batch_16384=ms_16k, verifies_per_s_16384=BIG_BATCH / ms_16k * 1e3,
        wrong_lanes_16384=big_wrong,
    )
    if wrong or big_wrong:
        raise SystemExit(f"accept mask differs from the expected one at lanes {wrong} ({big_wrong} at 16384)")
    fail_on_counts("verify", launches, missing, plain_used)
    fail_on_table_builds("verify", builds)
    ctx = dict(public=public, device_obj=device_obj, rng=rng, cb=cb, pb=pb, want=want, fast_mask=got,
               table_builds=builds, distinct=distinct)
    return launches, ctx


# -- phase: mirror ------------------------------------------------------------------


def phase_mirror(dev, ctx):
    """The mirror verifier on the verify phase's batch: the same mask as
    expected and as the fast verifier gave, through the ladder and the
    tree-sum kernels."""
    device_obj, cb, pb, want = ctx["device_obj"], ctx["cb"], ctx["pb"], ctx["want"]
    reset_counts()
    ok = run_verify(device_obj, cb, pb, fast=False)
    torch.cuda.synchronize()
    launches, missing, plain_used = path_counts("mirror")
    got = ok.cpu()
    assert got.dtype == torch.bool and tuple(got.shape) == (BATCH,)
    wrong = torch.nonzero(got != want).flatten().tolist()
    differs = torch.nonzero(got != ctx["fast_mask"]).flatten().tolist()
    ms = time_ms(lambda: run_verify(device_obj, cb, pb, fast=False), reps=5)
    emit(
        "mirror", ok=not wrong and not differs and not missing and not plain_used,
        batch=BATCH, accepted=int(got.sum()), rejected_lanes=torch.nonzero(~got).flatten().tolist(),
        wrong_lanes=wrong, lanes_differing_from_fast=differs, launches=launches,
        plain_calls=plain_used, ms_per_batch_1024=ms, verifies_per_s_1024=BATCH / ms * 1e3,
    )
    if wrong or differs:
        raise SystemExit(f"mirror mask: wrong at lanes {wrong}, differs from the fast verifier at {differs}")
    fail_on_counts("mirror", launches, missing, plain_used)
    ctx["mirror_mask"] = got
    return launches


# -- phase: prove -------------------------------------------------------------------


def make_prove_batch(rng, dev):
    """Prover inputs for the batch: four distinct lanes (value, s, blinding
    draws) tiled over it, and from lane 4 on a value of the lane's own."""
    xs = [0, 123456, 0xDEADBEEFCAFEBABE, 2**64 - 1]
    pbt = u64_prove_batch(rng, xs, BATCH, device=dev)
    own = np.random.default_rng(7).integers(0, 1 << 32, size=(2, BATCH - len(xs)), dtype=np.int64)
    pbt.x_words[:, len(xs):] = torch.from_numpy(own).to(dev)
    return pbt


def proof_lanes_equal(got, want, n: int) -> list:
    """Names of the fields of two ReciprocalProofBytes whose first n lanes differ."""
    bad = []

    def walk(a, b, name):
        if isinstance(a, torch.Tensor):
            if not torch.equal(a[..., :n].cpu(), b[..., :n].cpu()):
                bad.append(name)
            return
        for field, x, y in zip(a._fields, a, b):
            walk(x, y, f"{name}.{field}" if name else field)

    walk(got, want, "")
    return bad


def phase_prove(dev, ctx):
    """commit_value + prove for a batch on the card; the bytes of the
    distinct lanes against the host oracle under replayed draws; every
    produced proof through both verifiers."""
    public, device_obj = ctx["public"], ctx["device_obj"]
    pbt = make_prove_batch(ctx["rng"], dev)

    def run():
        com = device_obj.commit_value(pbt.x_words, pbt.s)
        proof = device_obj.prove(
            pbt.x_words, pbt.s, Transcript(LABEL, batch=(BATCH,), device=dev), pbt.blind)
        return com, proof

    reset_counts()
    # the first prove makes the row index of each table subset it walks: its
    # peak is the fixture's memory with the prover's working set on top
    torch.cuda.reset_peak_memory_stats()
    com, proof = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches, missing, plain_used = path_counts("prove")
    pb = cv.reciprocal_dev_to_bytes(proof)
    cb = dc.compress(com)

    oracle_proofs, oracle_coms = [], []
    for ln in pbt.lanes:
        oracle_coms.append(public.commit_value(ln["x"], ln["s"]))
        oracle_proofs.append(
            public.prove(ln["x"], ln["s"], HostTranscript(LABEL), ReplayRng(ln["draws"])))
    n = len(pbt.lanes)
    oracle_pb = cv.reciprocal_proofs_to_bytes(oracle_proofs, device="cpu")
    differing = proof_lanes_equal(pb, oracle_pb, n)
    if not torch.equal(cb[:, :n].cpu(), torch.from_numpy(cv.point_bytes(oracle_coms))):
        differing.append("commitment")

    reset_counts()
    ok_fast = run_verify(device_obj, cb, pb, fast=True).cpu()
    ok_mirror = run_verify(device_obj, cb, pb, fast=False).cpu()
    _, plain_verify = read_counts()
    plain_used.update({k: v for k, v in plain_verify.items() if v})
    rejected = sorted(set(torch.nonzero(~ok_fast).flatten().tolist())
                      | set(torch.nonzero(~ok_mirror).flatten().tolist()))

    ms = time_ms(run, reps=5)
    emit(
        "prove", ok=not differing and not rejected and not missing and not plain_used,
        batch=BATCH, distinct_lanes=n, fields_differing_from_oracle=differing,
        accepted_fast=int(ok_fast.sum()), accepted_mirror=int(ok_mirror.sum()),
        rejected_lanes=rejected, launches=launches, plain_calls=plain_used,
        table_subsets=len(device_obj.tables["full"].subsets),
        row_index_bytes=sum(t.rows.numel() * 4 for t in device_obj.tables["full"].subsets.values()),
        peak_memory_bytes=peak,
        ms_per_batch_1024=ms, proves_per_s_1024=BATCH / ms * 1e3,
    )
    if differing:
        raise SystemExit(f"proof bytes differ from the oracle's in {differing}")
    if rejected:
        raise SystemExit(f"a verifier rejects proofs the port made, lanes {rejected[:20]}")
    fail_on_counts("prove", launches, missing, plain_used)
    ctx.update(pbt=pbt, prove_pb=pb, prove_cb=cb, oracle_pb=oracle_pb)
    return launches


# -- phase: variants -------------------------------------------------------------------


def phase_variants(dev, ctx):
    """The three u64 paths on the verify and prove phases' batches under each
    non-default small-MSM switch: the same masks, the same proof bytes on
    every lane, and the switch's kernel launched where K4 is not.
    -> {path: launches}."""
    device_obj, cb, pb, want = ctx["device_obj"], ctx["cb"], ctx["pb"], ctx["want"]
    pbt = ctx["pbt"]

    def run_prove():
        com = device_obj.commit_value(pbt.x_words, pbt.s)
        proof = device_obj.prove(
            pbt.x_words, pbt.s, Transcript(LABEL, batch=(BATCH,), device=dev), pbt.blind)
        return com, proof

    out = {}
    for tag, env in VARIANTS.items():
        with switches(env):
            kernel = dc.small_msm_variant()
            report, failures = {}, []
            for fast, path in ((True, f"verify_{tag}"), (False, f"mirror_{tag}")):
                reset_counts()
                got = run_verify(device_obj, cb, pb, fast=fast).cpu()
                torch.cuda.synchronize()
                out[path], missing, plain_used = path_counts(path)
                wrong = torch.nonzero(got != want).flatten().tolist()
                base = ctx["fast_mask"] if fast else ctx["mirror_mask"]
                differs = torch.nonzero(got != base).flatten().tolist()
                ms = time_ms(lambda: run_verify(device_obj, cb, pb, fast=fast), reps=3)
                report[path] = dict(wrong_lanes=wrong, lanes_differing_from_default=differs,
                                    ms_per_batch_1024=ms, launches=out[path], plain_calls=plain_used)
                if wrong or differs:
                    failures.append(f"{path}: mask wrong at {wrong}, differs from the default at {differs}")
                failures += count_faults(path, out[path], missing, plain_used)
            path = f"prove_{tag}"
            reset_counts()
            com, proof = run_prove()
            torch.cuda.synchronize()
            out[path], missing, plain_used = path_counts(path)
            vpb = cv.reciprocal_dev_to_bytes(proof)
            vcb = dc.compress(com)
            n = len(pbt.lanes)
            vs_default = proof_lanes_equal(vpb, ctx["prove_pb"], BATCH)
            vs_oracle = proof_lanes_equal(vpb, ctx["oracle_pb"], n)
            if not torch.equal(vcb, ctx["prove_cb"]):
                vs_default.append("commitment")
            ms = time_ms(run_prove, reps=3)
            report[path] = dict(fields_differing_from_default=vs_default,
                                fields_differing_from_oracle=vs_oracle, ms_per_batch_1024=ms,
                                launches=out[path], plain_calls=plain_used)
            if vs_default or vs_oracle:
                failures.append(f"{path}: bytes differ from the default prover's in {vs_default}, "
                                f"from the oracle's in {vs_oracle}")
            failures += count_faults(path, out[path], missing, plain_used)
        emit("variants", ok=not failures, switches=env, kernel=kernel, batch=BATCH, paths=report)
        if failures:
            raise SystemExit("; ".join(failures))
    return out


# -- phase: wnla ------------------------------------------------------------------------


def phase_wnla(dev):
    """The standalone WNLA at |l| = |n| = 16, 32, 64 over a batch of 1024:
    commit + prove with the proof bytes of the distinct lanes against the
    oracle's, then the mirror and the collapsed verifier on the honest
    proofs and with one lane tampered. -> ({path: launches}, the fixtures'
    table builds)."""
    out, all_builds = {}, []
    for sz in WNLA_SIZES:
        path = f"wnla{sz}"
        t0 = time.time()
        builds = []
        with timing_table_builds(builds):
            fx = wnla_fixture(f"{SEED} wnla {sz}", sz, sz, BATCH, device=dev, tables="auto")
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        d, n = fx.dev, len(fx.lanes)

        def transcript():
            return Transcript(fx.label, batch=(BATCH,), device=dev)

        def prove():
            com = d.commit(fx.l, fx.n)
            return com, d.prove(com, transcript(), fx.l, fx.n)

        reset_counts()
        com, proof = prove()
        pb = cv.wnla_dev_to_bytes(proof)
        ok_m = d.verify(fx.com, transcript(), pb)
        ok_f = d.verify_fast(fx.com, transcript(), pb)
        torch.cuda.synchronize()
        out[path], missing, plain_used = path_counts(path)
        differing = proof_lanes_equal(
            pb, cv.wnla_proofs_to_bytes([ln["proof"] for ln in fx.lanes], device="cpu"), n)
        if not torch.equal(dc.compress(com)[:, :n].cpu(),
                           torch.from_numpy(cv.point_bytes([ln["com"] for ln in fx.lanes]))):
            differing.append("commitment")
        bad = pb.l.clone()
        bad[0, 0, TAMPERED] = (bad[0, 0, TAMPERED] + 1) % (1 << 16)
        tampered = pb._replace(l=bad)
        want = torch.ones(BATCH, dtype=torch.bool)
        want[TAMPERED] = False
        masks = dict(
            mirror=ok_m.cpu(), fast=ok_f.cpu(),
            mirror_tampered=d.verify(fx.com, transcript(), tampered).cpu(),
            fast_tampered=d.verify_fast(fx.com, transcript(), tampered).cpu(),
        )
        wrong = {k: torch.nonzero(m != (want if "tampered" in k else True)).flatten().tolist()
                 for k, m in masks.items()}
        wrong = {k: v for k, v in wrong.items() if v}
        ms_prove = time_ms(prove, reps=3)
        ms_verify = time_ms(lambda: d.verify(fx.com, transcript(), pb), reps=3)
        ms_fast = time_ms(lambda: d.verify_fast(fx.com, transcript(), pb), reps=3)
        emit(
            "wnla", ok=not differing and not wrong and not missing and not plain_used,
            size=sz, rounds=proof.x.x.shape[1], batch=BATCH, distinct_lanes=n,
            fields_differing_from_oracle=differing, wrong_lanes=wrong,
            launches=out[path], plain_calls=plain_used, fixture_seconds=setup_s,
            table_builds=builds, table_points=d.tables.n_points, table_bytes=d.tables.words.numel() * 4,
            table_subsets=len(d.tables.subsets),
            row_index_bytes=sum(t.rows.numel() * 4 for t in d.tables.subsets.values()),
            ms_per_batch_commit_and_prove=ms_prove, ms_per_batch_verify=ms_verify,
            ms_per_batch_verify_fast=ms_fast,
        )
        if differing:
            raise SystemExit(f"WNLA {sz}: proof bytes differ from the oracle's in {differing}")
        if wrong:
            raise SystemExit(f"WNLA {sz}: masks wrong at {wrong}")
        fail_on_counts(path, out[path], missing, plain_used)
        fail_on_table_builds(path, builds)
        all_builds += builds
    return out, all_builds


# -- phase: circuit ---------------------------------------------------------------------


def circuit_bytes_equal(pb, want, n: int) -> list:
    """Names of the fields of two CircuitProofBytes whose lanes differ, `want`
    holding the n distinct lanes that `pb`'s lanes tile."""
    tiled = map_tensors(want, lambda a: a.repeat((1,) * (a.ndim - 1) + (-(-BATCH // n),))
                         [..., :BATCH])
    return proof_lanes_equal(pb, tiled, BATCH)


def phase_circuit(dev):
    """The standalone arithmetic circuit over a batch of 1024 on the generic
    dense path: ac_works without tables, the reciprocal-decomposition
    circuit at the u64 dims with the u64 tables; prove under replayed
    draws (bytes of every lane equal the oracle's proof of its distinct
    lane), both verifiers on the produced proofs with one lane's C_S and
    another's first WNLA scalar tampered. -> ({path: launches}, the
    fixtures' table builds)."""
    out, all_builds = {}, []
    for kind, tables in (("ac", "never"), ("reciprocal", "auto")):
        path = f"circuit_{kind}"
        reset_counts()
        t0 = time.time()
        builds = []
        with timing_table_builds(builds):
            fx = circuit_fixture(kind, BATCH, device=dev, tables=tables)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        n = len(fx.lanes)
        for ln in fx.lanes:
            assert fx.circuit.verify(ln["v"], HostTranscript(fx.label), ln["proof"]), \
                f"{kind}: the oracle rejects its own proof"

        def transcript():
            return Transcript(fx.label, batch=(BATCH,), device=dev)

        def prove():
            return fx.dev.prove(fx.v, fx.v_bytes, fx.witness, transcript(), fx.blind)

        def verify(pb, fast):
            return fx.dev.verify(fx.v, fx.v_bytes, transcript(), pb, fast=fast)

        proof = prove()
        pb = cv.circuit_dev_to_bytes(proof)
        c_s, wl = pb.c_s.clone(), pb.wnla.l.clone()
        c_s[1, CIRCUIT_TAMPERED["c_s"]] ^= 1
        lane = CIRCUIT_TAMPERED["wnla.l"]
        wl[0, 0, lane] = (wl[0, 0, lane] + 1) % (1 << 16)
        tampered = pb._replace(c_s=c_s, wnla=pb.wnla._replace(l=wl))
        want = torch.ones(BATCH, dtype=torch.bool)
        want[list(CIRCUIT_TAMPERED.values())] = False
        masks = {f"{name}{'_tampered' if t else ''}": verify(tampered if t else pb, fast).cpu()
                 for name, fast in (("fast", True), ("mirror", False)) for t in (False, True)}
        torch.cuda.synchronize()
        out[path], missing, plain_used = path_counts(path)
        differing = circuit_bytes_equal(
            pb, cv.circuit_proofs_to_bytes([ln["proof"] for ln in fx.lanes], device="cpu"), n)
        wrong = {k: torch.nonzero(m != (want if "tampered" in k else True)).flatten().tolist()
                 for k, m in masks.items()}
        wrong = {k: v for k, v in wrong.items() if v}
        ms_prove = time_ms(prove, reps=3)
        ms_fast = time_ms(lambda: verify(pb, True), reps=3)
        ms_mirror = time_ms(lambda: verify(pb, False), reps=3)
        d = fx.dev
        emit("circuit", ok=not differing and not wrong and not missing and not plain_used,
             instance=kind, dims=dict(nm=d.dim_nm, no=d.dim_no, nv=d.dim_nv, nl=d.dim_nl,
                                      nw=d.dim_nw, k=d.k, g_vec_=int(d.g_vec_.x.shape[1]),
                                      h_vec_=int(d.h_vec_.x.shape[1])),
             generic_collect_c=d.collect_c_override is None, tables=d.tables is not None,
             batch=BATCH, distinct_lanes=n, fields_differing_from_oracle=differing,
             wrong_lanes=wrong, tampered_lanes=CIRCUIT_TAMPERED, launches=out[path],
             plain_calls=plain_used, fixture_seconds=setup_s, table_builds=builds,
             ms_per_batch_prove=ms_prove, ms_per_batch_verify_fast=ms_fast,
             ms_per_batch_verify_mirror=ms_mirror)
        if differing:
            raise SystemExit(f"circuit {kind}: proof bytes differ from the oracle's in {differing}")
        if wrong:
            raise SystemExit(f"circuit {kind}: masks wrong at {wrong}")
        fail_on_counts(path, out[path], missing, plain_used)
        if tables != "never":
            fail_on_table_builds(path, builds)
        all_builds += builds
    return out, all_builds


# -- phases: wire, entry ---------------------------------------------------------------


def wire_blobs(proofs, B: int) -> list:
    """The verify phase's batch as 525-byte wire blobs: the four oracle
    proofs packed by `native.pack_oracle_proof`, tiled over B lanes, and
    lanes 4, 5, 7, 8, 9 and 10 tampered in their bytes as `make_batch`
    tampers its tensors (lane 6's fault is its commitment, not its blob)."""
    P, SC = 33, native.N_POINTS * 33  # a point's bytes; where the scalars start
    blobs = [bytearray(native.pack_oracle_proof(proofs[b % 4])) for b in range(B)]
    blobs[4][4 * P + 5] ^= 0x40  # byte 5 of the poles commitment R
    limb0 = (blobs[5][SC + 30] << 8 | blobs[5][SC + 31]) + 1  # limb 0 of l[0]
    blobs[5][SC + 30:SC + 32] = (limb0 % (1 << 16)).to_bytes(2, "big")
    blobs[7][3 * P] = 7  # C_S's SEC1 tag
    blobs[8][SC + 64:SC + 96] = (N_INT + 5).to_bytes(32, "big")  # n[0] >= n
    blobs[9][7 * P + 3] ^= 0x11  # byte 3 of X[2]
    blobs[10][4 * P:5 * P] = bytes([2]) + b"\xff" * 32  # R's x >= p
    return [bytes(b) for b in blobs]


def phase_wire(dev, ctx):
    """The verify phase's proofs as wire blobs through `native.pack_batch`
    into both u64 verifiers: the packed tensors equal the verify phase's,
    the masks the expected one. The C++ host engine's verifier on 16 blobs
    as a host baseline."""
    device_obj, cb, want = ctx["device_obj"], ctx["cb"], ctx["want"]
    blobs = wire_blobs(ctx["distinct"][1], BATCH)
    reset_counts()
    pb, pack_ms = timed_once(lambda: native.pack_batch(blobs, device=dev))
    masks = {"fast": run_verify(device_obj, cb, pb, fast=True).cpu(),
             "mirror": run_verify(device_obj, cb, pb, fast=False).cpu()}
    torch.cuda.synchronize()
    launches, missing, plain_used = path_counts("wire")
    differing = proof_lanes_equal(pb, ctx["pb"], BATCH)
    wrong = {k: torch.nonzero(m != want).flatten().tolist() for k, m in masks.items()}
    wrong = {k: v for k, v in wrong.items() if v}
    ms_pack = time_ms(lambda: native.pack_batch(blobs, device=dev), reps=5)
    # the host engine: one blob at a time on one core
    public, n_host = ctx["public"], 16
    com_bytes = [bytes(cb[:, b].cpu().to(torch.uint8).tolist()) for b in range(n_host)]
    native.load()
    t0 = time.perf_counter()
    host = [native.u64_verify(public, com_bytes[b], LABEL, blobs[b]) for b in range(n_host)]
    host_ms = (time.perf_counter() - t0) * 1e3 / n_host
    host_wrong = [b for b in range(n_host) if host[b] != bool(want[b])]
    emit("wire", ok=not differing and not wrong and not host_wrong and not missing
         and not plain_used, batch=BATCH, blob_bytes=native.PROOF_BYTES,
         fields_differing_from_verify_phase=differing, wrong_lanes=wrong,
         rejected_lanes=torch.nonzero(~masks["fast"]).flatten().tolist(), launches=launches,
         plain_calls=plain_used, ms_pack_batch_first=pack_ms, ms_pack_batch=ms_pack,
         host_engine=dict(blobs=n_host, ms_per_verify=host_ms, wrong_lanes=host_wrong,
                          library=native.lib_path()))
    if differing:
        raise SystemExit(f"pack_batch differs from the verify phase's tensors in {differing}")
    if wrong or host_wrong:
        raise SystemExit(f"wire masks wrong at {wrong}, host engine at {host_wrong}")
    fail_on_counts("wire", launches, missing, plain_used)
    ctx.update(wire_pb=pb, wire_mask=masks["fast"])
    return launches


def phase_entry(dev, ctx):
    """`entry()` on the card: its step on its zero arguments rejects every
    lane; the same step on the wire phase's arguments (the verify phase's
    instance, commitments and packed blobs) gives the wire mask."""
    reset_counts()
    t0 = time.time()
    builds = []
    with timing_table_builds(builds):
        step, args = entry(device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    zero_mask = step(*args).cpu()
    wire_args = (ctx["device_obj"], ctx["cb"], ctx["wire_pb"])
    wire_mask = step(*wire_args).cpu()
    torch.cuda.synchronize()
    launches, missing, plain_used = path_counts("entry")
    ok_zero = tuple(zero_mask.shape) == (BATCH,) and not bool(zero_mask.any())
    same = torch.equal(wire_mask, ctx["wire_mask"])
    ms = time_ms(lambda: step(*wire_args), reps=5)
    emit("entry", ok=ok_zero and same and not missing and not plain_used, batch=BATCH,
         zero_args_all_rejected=ok_zero, wire_mask_equal=same, launches=launches,
         plain_calls=plain_used, setup_seconds=setup_s, table_builds=builds,
         ms_per_step=ms)
    if not (ok_zero and same):
        raise SystemExit(f"entry: zero arguments all rejected {ok_zero}, wire mask equal {same}")
    fail_on_counts("entry", launches, missing, plain_used)
    fail_on_table_builds("entry", builds)
    return launches, builds


# -- phase: pippenger --------------------------------------------------------------------


def pippenger_inputs(gen, L: int, dev):
    """L random points and scalars on each of BATCH lanes; lane 0 has an
    identity point, lane 1 a zero scalar, lane 2 one point three times
    (other scalars: equal digits meet in the sorted scan), lane 3 a point
    and its negation under one scalar (equal digits everywhere: the scan
    adds P to -P). Two equal points under one scalar would make ladder +
    sum, whose sum adds with incomplete adds (K7), wrong on that lane."""
    P = rand_points(gen, (L, BATCH), dev)
    S = rand_scalars(gen, (L, BATCH), N_INT, dev)
    idl = dc.identity((), device=dev)
    for a, i in zip(P, idl):
        a[:, 1, 0] = i
        a[:, 4, 2] = a[:, 3, 2]
        a[:, 5, 2] = a[:, 3, 2]
        a[:, 6, 3] = a[:, 7, 3]
    P.y[:, 6, 3] = f.fp_neg(P.y[:, 7, 3])
    S[:, 2, 1] = 0
    S[:, 6, 3] = S[:, 7, 3]
    return P, S


def phase_pippenger(dev):
    """`msm_pippenger` against `curve.msm` (K6 ladder + K7 sum) at the WNLA
    final MSMs' point counts over a batch of 1024: equal as points on every
    lane (and to the host oracle on the four edge lanes); launches and
    times of both routes, timed in turns. -> {path: launches}."""
    gen = np.random.default_rng(99)
    report, failures, counted, fns = [], [], None, []
    for L in PIPPENGER_L:
        P, S = pippenger_inputs(gen, L, dev)
        reset_counts()
        got = pippenger.msm_pippenger(P, S)
        torch.cuda.synchronize()
        launches, missing, plain_used = path_counts("pippenger")
        faults = count_faults("pippenger", launches, missing, plain_used)
        reset_counts()
        ref = dc.msm(P, S)
        torch.cuda.synchronize()
        msm_launches, _ = read_counts()
        bad = torch.nonzero(~dc.pt_eq(got, ref)).flatten().tolist()
        host = []
        for b in range(4):
            acc = oc.IDENTITY
            for p, k in zip(cv.point_vec_lane(P, b), cv.scalars_lane(S, b)):
                acc = acc.add(p.mul(k))
            host.append(cv.point_lane(got, b).to_bytes() == acc.to_bytes())
        fns += [lambda P=P, S=S: pippenger.msm_pippenger(P, S), lambda P=P, S=S: dc.msm(P, S)]
        turns = [time_ms(fn, reps=3) for fn in (fns[-2], fns[-1], fns[-1], fns[-2])]
        report.append(dict(
            L=L, c=pippenger._pick_c(L), lanes=BATCH, lanes_differing_from_msm=bad, oracle_edge_lanes=host,
            launches=launches, msm_launches={k: v for k, v in msm_launches.items() if v},
            ms=(turns[0] + turns[3]) / 2, msm_ms=(turns[1] + turns[2]) / 2))
        if bad or not all(host):
            failures.append(f"L={L}: differs from msm at lanes {bad[:20]}, oracle edge lanes {host}")
        failures += faults
        counted = launches if counted is None else {k: counted[k] + launches[k] for k in counted}
    emit("pippenger", ok=not failures, batch=BATCH, route_of_msm="ladder + tree (unchanged)",
         sizes=report)
    if failures:
        raise SystemExit("; ".join(failures))
    # the hand-written kernels' device time of both routes at every size is
    # taken in the kernels phase's profiler session (`timed_calls`)
    timed = [dict(L=L, route=route, device_fn=fn)
             for L, pair in zip(PIPPENGER_L, zip(fns[0::2], fns[1::2]))
             for route, fn in zip(("pippenger", "ladder + sum"), pair)]
    return {"pippenger": counted}, timed


# -- phase: parallel ----------------------------------------------------------------------

PARALLEL_RANKS = 4  # ranks that share the one card in the second run
TP_POINTS = (48, 128)  # the u64 [h_vec | g_vec], WNLA-64's
SP_SIZE = 64
# what the parts of the parallel phase launch on every rank: dp builds its
# tables and verifies; tp runs the local MSMs (K6 + K7) and the complete
# combine (K5a); sp the whole prover. Where the world is one rank, tp's one
# partial needs no add, and sp's tail (2/2 there, 4/4 over four ranks)
# folds no more, so no Straus MSM doubles (K5b).
PATH_KERNELS["parallel_dp"] = PATH_KERNELS["verify"]
PATH_KERNELS["parallel_tp"] = ("scalar_mul", "tree_sum", "pt_add")
PATH_KERNELS["parallel_sp"] = ("f1600", "pow_const", "msm_small_wnaf", "pt_add", "pt_double",
                               "scalar_mul", "tree_sum")
SHARDED_ONLY = {"parallel_tp": ("pt_add",), "parallel_sp": ("pt_double",)}
PARALLEL_REPS = {"dp": 3, "tp": 5, "sp": 2}
SHAPE_KEYS = ("scalar_mul", "tree_sum", "pt_add", "f1600", "pt_double")


@contextlib.contextmanager
def counting_collectives():
    """For the block, count every `all_gather` and `all_reduce` of
    torch.distributed: calls, the bytes this rank puts in, and the seconds
    each takes with the card synchronised before and after it, which
    include this rank's wait for the others to arrive (so the block's
    other timings are not taken under this)."""
    stats = {"all_gather": [0, 0, 0.0], "all_reduce": [0, 0, 0.0]}
    orig = dist.all_gather, dist.all_reduce

    def counted(name, fn, which):
        def call(*args, **kw):
            t = args[which]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            s = stats[name]
            s[0] += 1
            s[1] += t.numel() * t.element_size()
            s[2] += time.perf_counter() - t0
            return out
        return call

    dist.all_gather = counted("all_gather", orig[0], 1)
    dist.all_reduce = counted("all_reduce", orig[1], 0)
    try:
        yield stats
    finally:
        dist.all_gather, dist.all_reduce = orig


def collective_summary(stats) -> dict:
    calls = sum(s[0] for s in stats.values())
    nbytes = sum(s[1] for s in stats.values())
    return dict(collectives=calls, bytes=nbytes, bytes_per_collective=nbytes / calls if calls else 0,
                seconds=sum(s[2] for s in stats.values()),
                by_kind={k: dict(calls=s[0], bytes=s[1], seconds=s[2]) for k, s in stats.items()})


def parallel_inputs(ctx):
    """Every part's inputs as CPU tensors, built once here and handed to the
    ranks: dp the verify phase's batch and instance; tp the u64 and WNLA-64
    [h_vec | g_vec] at full width with random scalars, lane 1 holding its
    first block's points and scalars again as its second block (equal
    partials) and lane 2 zero scalars in its third block (an identity
    partial), blocks as four ranks cut them; sp the WNLA-64 instance."""
    cpu = lambda t: map_tensors(t, lambda a: a.cpu())
    d = ctx["device_obj"]
    fx = wnla_fixture(f"{SEED} parallel", SP_SIZE, SP_SIZE, BATCH, device="cpu", tables="never")
    gen = np.random.default_rng(11)
    tp = []
    for vecs in ((d.h_vec, d.g_vec), (fx.dev.h_vec, fx.dev.g_vec)):
        pts = dc.PointJ(*(torch.cat([h, g], dim=1).cpu().contiguous() for h, g in zip(*vecs)))
        L = pts.x.shape[1]
        sc = rand_scalars(gen, (L, BATCH), N_INT, "cpu")
        per = L // PARALLEL_RANKS
        for a in (*pts, sc):
            a[:, per : 2 * per, 1] = a[:, :per, 1]
        sc[:, 2 * per : 3 * per, 2] = 0
        tp.append((pts, sc))
    w = fx.dev
    return dict(
        dp=dict(gens=cpu((d.g, d.g_vec, d.h_vec)), cb=ctx["cb"].cpu(), pb=cpu(ctx["pb"])),
        tp=tp,
        sp=(w.g, w.g_vec, w.h_vec, w.c, w.rho, w.mu, fx.com, fx.label, fx.l, fx.n),
        sp_lanes=[ln["proof"] for ln in fx.lanes],
    )


def run_parallel_parts(inp) -> dict:
    """dp, tp and sp on meshes over the whole initialized world, on this
    rank's card: per part its results (CPU), its launches and plain calls
    on the checked call (counts set to 0 just before it), its collectives
    there, and its ms per call by CUDA events over PARALLEL_REPS more
    calls, which every rank starts together."""
    out = {}

    def part(name, run, timed):
        reset_counts()
        with counting_collectives() as stats:
            res = run()
            torch.cuda.synchronize()
        launches, plain = read_counts()
        dist.barrier()
        ms = time_ms(timed, reps=PARALLEL_REPS[name], warm=0)
        out[name] = dict(res=res, launches=dict(launches), plain_calls={k: n for k, n in plain.items() if n},
                         ms=ms, **collective_summary(stats))

    # dp: the batch cut across the ranks; each rank builds its tables
    mesh = multihost.global_dp_mesh(device="cuda")
    on_card = lambda t: map_tensors(t, lambda a: a.to(mesh.device))
    dp = {}

    def run_dp():
        g, g_vec, h_vec = shard_batch(inp["dp"]["gens"], mesh)
        lane0 = lambda p: dc.PointJ(*(a[..., 0] for a in p))
        dp["obj"] = U64RangeProofDevice(g=g, g_vec=g_vec, h_vec=h_vec,
                                        tables=build_u64_tables(lane0(g), lane0(g_vec), lane0(h_vec)))
        dp["cb"], dp["pb"] = shard_batch((inp["dp"]["cb"], inp["dp"]["pb"]), mesh)
        return dict(mask=run_verify(dp["obj"], dp["cb"], dp["pb"], fast=True).cpu(),
                    first_lane=batch_slice(mesh, BATCH).start)

    part("dp", run_dp, lambda: run_verify(dp["obj"], dp["cb"], dp["pb"], fast=True))

    # tp: the global points and scalars on every rank's card, blocks cut there
    tp_mesh = make_mesh(axis="tp", device="cuda")
    tp = on_card(inp["tp"])
    part("tp", lambda: [dc.compress(msm_sharded(p, s, tp_mesh)).cpu() for p, s in tp],
         lambda: [msm_sharded(p, s, tp_mesh) for p, s in tp])

    # sp: the global WNLA-64 instance on every rank's card
    sp_mesh = make_mesh(axis="sp", device="cuda")
    sp = on_card(inp["sp"])
    part("sp", lambda: map_tensors(cv.wnla_dev_to_bytes(prove_sharded(sp_mesh, *sp)), lambda a: a.cpu()),
         lambda: prove_sharded(sp_mesh, *sp))
    return out


def _parallel_rank(rank, rdzv, workdir):
    """One of the ranks that share the card: the parts over gloo on the
    inputs the parent saved, the results and the shapes the kernels were
    given saved for the parent."""
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    multihost.initialize(rdzv, PARALLEL_RANKS, rank, backend="gloo", device="cuda")
    try:
        log = new_shape_log()
        with recording_shapes(log, "parallel"):
            res = run_parallel_parts(inp)
        res["shapes"] = {k: log[k] for k in SHAPE_KEYS}
        torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_faults(world: int, ranks: list, want: dict) -> dict:
    """What is wrong with the ranks' results, by part: results unlike
    `want`, kernels of the part never launched on a rank, plain calls."""
    faults = {}
    masks = torch.cat([r["dp"]["res"]["mask"] for r in sorted(ranks, key=lambda r: r["dp"]["res"]["first_lane"])])
    if not torch.equal(masks, want["mask"]):
        faults["dp"] = [f"mask differs at lanes {torch.nonzero(masks != want['mask']).flatten().tolist()}"]
    for i, r in enumerate(ranks):
        for L, got, ref in zip(TP_POINTS, r["tp"]["res"], want["tp"]):
            bad = torch.nonzero((got != ref).any(dim=0)).flatten().tolist()
            if bad:
                faults.setdefault("tp", []).append(f"rank {i}, L = {L}: lanes {bad[:8]}")
        bad = proof_lanes_equal(r["sp"]["res"], want["sp"], BATCH)
        if bad:
            faults.setdefault("sp", []).append(f"rank {i}: {bad} differ from the single-card prover")
        for part in ("dp", "tp", "sp"):
            path = f"parallel_{part}"
            need = [k for k in PATH_KERNELS[path] if world > 1 or k not in SHARDED_ONLY.get(path, ())]
            faults.setdefault(part, []).extend(
                count_faults(f"{path} (rank {i} of {world})", r[part]["launches"],
                             [k for k in need if r[part]["launches"][k] == 0], r[part]["plain_calls"]))
    return {k: v for k, v in faults.items() if v}


def phase_parallel(dev, ctx, shapes):
    """The scale-out layer on the card: (a) world size 1 over NCCL in this
    process, (b) PARALLEL_RANKS ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card), spawned after the build; in each the
    parts dp, tp and sp at full width, held against the same work without
    `parallel/` (the verify phase's mask, `curve.msm`, the single-card
    `WNLADevice.prove`, whose bytes the oracle's on the distinct lanes);
    then `dryrun_multichip(PARALLEL_RANKS, backend="gloo")`. -> {path:
    launches summed over the ranks of (b)}."""
    inp = parallel_inputs(ctx)
    on_card = lambda t: map_tensors(t, lambda a: a.to(dev))

    # the same work without parallel/, in this process
    tp_in = on_card(inp["tp"])
    tp_ref = [dc.compress(dc.msm(p, s)).cpu() for p, s in tp_in]
    sp_in = on_card(inp["sp"])
    wnla = WNLADevice(*sp_in[:6])
    com, label, l, n = sp_in[6:]
    ref = cv.wnla_dev_to_bytes(wnla.prove(com, Transcript(label, batch=(BATCH,), device=dev), l, n))
    want = dict(mask=ctx["fast_mask"], tp=tp_ref, sp=map_tensors(ref, lambda a: a.cpu()))
    oracle_bad = proof_lanes_equal(ref, cv.wnla_proofs_to_bytes(inp["sp_lanes"], device="cpu"),
                                   len(inp["sp_lanes"]))
    plain_ms = dict(
        dp=time_ms(lambda: run_verify(ctx["device_obj"], ctx["cb"], ctx["pb"], fast=True), reps=3),
        tp=time_ms(lambda: [dc.msm(p, s) for p, s in tp_in], reps=5),
        sp=time_ms(lambda: wnla.prove(com, Transcript(label, batch=(BATCH,), device=dev), l, n),
                   reps=2, warm=0),
    )

    # (a) world size 1, NCCL
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/rendezvous", 1, 0, backend="nccl", device=dev)
        try:
            with recording_shapes(shapes, "parallel"):
                one = run_parallel_parts(inp)
        finally:
            dist.destroy_process_group()
    # the mirror verifier on the sharded proof: honest, and one WNLA scalar lane tampered
    pb = on_card(one["sp"]["res"])
    bad = pb.l.clone()
    bad[0, 0, TAMPERED] = (bad[0, 0, TAMPERED] + 1) % (1 << 16)
    verify = lambda p: wnla.verify(com, Transcript(label, batch=(BATCH,), device=dev), p).cpu()
    sp_masks = dict(honest=verify(pb), tampered=verify(pb._replace(l=bad)))
    expect = dict(honest=torch.ones(BATCH, dtype=torch.bool), tampered=torch.arange(BATCH) != TAMPERED)
    sp_wrong = {k: torch.nonzero(m != expect[k]).flatten().tolist() for k, m in sp_masks.items()}

    # (b) four ranks on the one card, gloo
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(inp, os.path.join(tmp, "inputs.pt"))
        torch.multiprocessing.spawn(_parallel_rank, nprocs=PARALLEL_RANKS, join=True,
                                    args=(f"file://{tmp}/rendezvous", tmp))
        four = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(PARALLEL_RANKS)]
    spawn_s = time.time() - t0
    for r in four:
        for k in SHAPE_KEYS:
            shapes[k] |= r["shapes"][k]

    runs = {1: [one], PARALLEL_RANKS: four}
    faults = {w: parallel_faults(w, rs, want) for w, rs in runs.items()}
    if oracle_bad:
        faults[1].setdefault("sp", []).append(f"the single-card prover's {oracle_bad} differ from the oracle's")
    if any(sp_wrong.values()):
        faults[1].setdefault("sp", []).append(f"mirror verify of the sharded proof wrong at {sp_wrong}")
    for w, rs in runs.items():
        for part in ("dp", "tp", "sp"):
            ms = [r[part]["ms"] for r in rs]
            line = dict(
                ok=not faults[w].get(part), part=part, world=w,
                backend="nccl" if w == 1 else "gloo", batch=BATCH, faults=faults[w].get(part, []),
                ms_per_call_by_rank=ms, ms_per_call_slowest_rank=max(ms), plain_ms_per_call=plain_ms[part],
                launches_by_rank=[r[part]["launches"] for r in rs],
                collectives_by_rank=[{k: r[part][k] for k in ("collectives", "bytes", "bytes_per_collective",
                                                              "seconds", "by_kind")} for r in rs],
            )
            if part == "dp":
                line.update(lanes_per_rank=BATCH // w, verifies_per_s=BATCH / max(ms) * 1e3,
                            verifies_per_s_without_parallel=BATCH / plain_ms["dp"] * 1e3)
            if part == "tp":
                line.update(points=list(TP_POINTS), edge_lanes=dict(equal_partials=1, identity_partial=2))
            if part == "sp":
                line.update(size=SP_SIZE, rounds=int(rs[0]["sp"]["res"].x.shape[1]),
                            sharded_rounds=_sharded_rounds(SP_SIZE, SP_SIZE, w))
                if w == 1:
                    line.update(mirror_verify_wrong_lanes=sp_wrong)
            if w > 1:
                line.update(spawn_seconds=spawn_s)
            emit("parallel", **line)

    t0 = time.time()
    dryrun_multichip(PARALLEL_RANKS, backend="gloo")
    emit("parallel", ok=True, part="dryrun_multichip", world=PARALLEL_RANKS, backend="gloo",
         seconds=time.time() - t0)
    bad = {w: f for w, f in faults.items() if f}
    if bad:
        raise SystemExit(f"parallel: {bad}")
    return {f"parallel_{part}": {k: sum(r[part]["launches"][k] for r in four) for k in four[0][part]["launches"]}
            for part in ("dp", "tp", "sp")}


HAND_WRITTEN = ("f1600_kernel", "f1600_lane_kernel", "pow_kernel", "pt_add_kernel", "pt_double_chain_kernel",
                "affine_rows_kernel",
                "fixed_msm_kernel", "fixed_msm_join_kernel", "msm_small_wnaf_kernel",
                "msm_small_wnaf_lane_kernel", "msm_small_glv_kernel", "msm_small_glv_lane_kernel",
                "msm_small_kernel", "scalar_mul_kernel", "scalar_mul_lane_kernel",
                "tree_sum_kernel")


def phase_profile(dev, path: str):
    """One batch of 1024 of `path` under torch.profiler: the device's busy
    and idle share, the number of launches, and the device time by kernel.
    A variant path ("verify_glv", ...) runs under its switch, set by the
    caller. The circuit paths profile one prove, "wire" one `pack_batch` and
    fast verify, "pippenger" one MSM over PIPPENGER_L[-1] points."""
    from torch.profiler import ProfilerActivity, profile

    base = path.partition("_")[0]
    if base == "circuit":
        kind = path.partition("_")[2]
        fx = circuit_fixture(kind, BATCH, device=dev, tables="never" if kind == "ac" else "auto")

        def run():
            return fx.dev.prove(fx.v, fx.v_bytes, fx.witness,
                                Transcript(fx.label, batch=(BATCH,), device=dev), fx.blind)

        run()
    elif base == "pippenger":
        P, S = pippenger_inputs(np.random.default_rng(99), PIPPENGER_L[-1], dev)

        def run():
            return pippenger.msm_pippenger(P, S)

        run()
    else:
        public, device_obj, rng = u64_fixture(SEED, BATCH, device=dev, tables="auto")
        distinct = oracle_proofs(public, rng)
        cb, pb, want, _ = make_batch(public, distinct, BATCH, dev)
    if base == "prove":
        pbt = make_prove_batch(rng, dev)

        def run():
            device_obj.commit_value(pbt.x_words, pbt.s)
            return device_obj.prove(
                pbt.x_words, pbt.s, Transcript(LABEL, batch=(BATCH,), device=dev), pbt.blind)

        run()
    elif base in ("verify", "mirror", "wire"):
        blobs = wire_blobs(distinct[1], BATCH) if base == "wire" else None

        def run():
            got = pb if blobs is None else native.pack_batch(blobs, device=dev)
            return run_verify(device_obj, cb, got, fast=base != "mirror")

        assert run().cpu().tolist() == want.tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        emit("profile", ok=False, path=path, wall_ms=wall_ms,
             note="the profiler recorded no device time: not measured")
        return
    rows.sort(key=lambda r: -r[1])
    ours = [r for r in rows if any(k in r[0] for k in HAND_WRITTEN)]
    emit(
        "profile", ok=True, path=path, batch=BATCH, wall_ms=wall_ms, profiled_wall_ms=profiled_wall_ms,
        device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
        device_launches=sum(r[2] for r in rows), distinct_kernels=len(rows),
        hand_written_ms=sum(r[1] for r in ours),
        hand_written=[dict(name=r[0][:90], ms=r[1], launches=r[2]) for r in ours],
        top=[dict(name=r[0][:90], ms=r[1], launches=r[2]) for r in rows[:12]],
    )


# -- main --------------------------------------------------------------------------------

REPLACES = {
    "f1600": ("bppp_tpu_torch/csrc/keccak.cu", "bppp_tpu/ops/pallas_keccak.py:114"),
    "pow_const": ("bppp_tpu_torch/csrc/pow.cu", "bppp_tpu/ops/pallas_msm.py:124"),
    "fixed_msm": ("bppp_tpu_torch/csrc/fixed_msm.cu", "bppp_tpu/ops/pallas_fixed_base.py:249"),
    "msm_small_wnaf": ("bppp_tpu_torch/csrc/msm_small.cu", "bppp_tpu/ops/pallas_msm.py:689"),
    "pt_add": ("bppp_tpu_torch/csrc/curve.cu", "bppp_tpu/ops/pallas_curve.py:71"),
    "pt_double": ("bppp_tpu_torch/csrc/curve.cu", "bppp_tpu/ops/pallas_curve.py:85"),
    "scalar_mul": ("bppp_tpu_torch/csrc/ladder.cu", "bppp_tpu/ops/pallas_msm.py:216"),
    "tree_sum": ("bppp_tpu_torch/csrc/ladder.cu", "bppp_tpu/ops/pallas_msm.py:748"),
    "msm_small_glv": ("bppp_tpu_torch/csrc/msm_small_u4.cu", "bppp_tpu/ops/pallas_msm.py:517"),
    "msm_small": ("bppp_tpu_torch/csrc/msm_small_u4.cu", "bppp_tpu/ops/pallas_msm.py:359"),
    # the table build's affine step: where the reference inverts every entry
    # with K2 (to_affine in pallas_fixed_base.py's build, fp_inv -> pow_const_flat)
    "affine_rows": ("bppp_tpu_torch/csrc/curve.cu", "bppp_tpu/ops/pallas_msm.py:124"),
}
# the row of the kernels phase that stands for each kernel at the main path's shapes
MAIN_ROW = {
    "f1600": f"f1600[B={BATCH}]", "pow_const": f"pow_const[fp_sqrt B={14 * BATCH}]", "fixed_msm": "fixed_msm[F=49]",
    "msm_small_wnaf": "msm_small_wnaf[D=5]", "pt_add": "pt_add",
    "pt_double": f"pt_double[n={CHAIN_N} B=49]",
    "scalar_mul": f"scalar_mul[B={32 * BATCH}]", "tree_sum": f"tree_sum[L=17 B={BATCH}]",
    "msm_small_glv": "msm_small_glv[D=3]", "msm_small": "msm_small[D=3]",
    "affine_rows": f"affine_rows[M={AFFINE_SHAPES[0][0]} NE={AFFINE_SHAPES[0][1]}]",
}
# the path whose run gives a kernel's `launches` in the kernels line
COUNTED_ON = {"scalar_mul": "mirror", "tree_sum": "mirror",
              "msm_small_glv": "verify_glv", "msm_small": "verify_noglv"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and the kernel comparison (at the u64 shapes: "
                    "the shapes the paths give K3, K5a, K6 and K7 are recorded only by a full run)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one batch of --path instead of the smoke phases")
    ap.add_argument("--parallel-only", action="store_true",
                    help="stop after the build, the verify phase (whose batch dp takes) and the "
                    "parallel phase")
    ap.add_argument("--path", choices=[p for p in PATH_KERNELS
                                       if not p.startswith(("wnla", "entry", "parallel"))],
                    default="verify", help="the path --profile runs (default: verify; "
                    "verify_glv etc. under BPPP_WNAF=0, verify_noglv etc. under BPPP_GLV=0; "
                    "circuit_ac / circuit_reciprocal: one prove; wire: pack_batch + fast "
                    "verify; pippenger: one MSM)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    info = _build.build_all()
    emit("build", seconds=info["seconds"], built=info["built"], resources=_build.resource_usage(),
         flags=" ".join(_build.NVCC_FLAGS))

    if args.profile:
        with switches(VARIANTS.get(args.path.partition("_")[2], {})):
            phase_profile(dev, args.path)
        print(smi, flush=True)
        return 0
    if args.kernels_only:
        public, device_obj, _ = u64_fixture(SEED, 4, device=dev, tables="auto")
        phase_kernels(dev, device_obj.tables)
        print(smi, flush=True)
        return 0
    if args.parallel_only:
        _, ctx = phase_verify(dev)
        t0 = time.time()
        phase_parallel(dev, ctx, new_shape_log())
        emit("walls", seconds={"parallel": time.time() - t0}, build_seconds=info["seconds"])
        print(smi, flush=True)
        return 0

    by_path, shapes, walls = {}, new_shape_log(), {}
    t0 = time.time()

    def wall(phase):
        nonlocal t0
        torch.cuda.synchronize()
        walls[phase] = time.time() - t0
        t0 = time.time()

    with recording_shapes(shapes, "verify"):
        by_path["verify"], ctx = phase_verify(dev)
    wall("verify")
    with recording_shapes(shapes, "mirror"):
        by_path["mirror"] = phase_mirror(dev, ctx)
    wall("mirror")
    with recording_shapes(shapes, "prove"):
        by_path["prove"] = phase_prove(dev, ctx)
    wall("prove")
    with recording_shapes(shapes, "variants"):
        by_path.update(phase_variants(dev, ctx))
    wall("variants")
    with recording_shapes(shapes, "wnla"):
        wnla, wnla_builds = phase_wnla(dev)
        by_path.update(wnla)
    wall("wnla")
    with recording_shapes(shapes, "circuit"):
        circuit, circuit_builds = phase_circuit(dev)
        by_path.update(circuit)
    wall("circuit")
    with recording_shapes(shapes, "wire"):
        by_path["wire"] = phase_wire(dev, ctx)
    wall("wire")
    with recording_shapes(shapes, "entry"):
        by_path["entry"], entry_builds = phase_entry(dev, ctx)
    wall("entry")
    with recording_shapes(shapes, "pippenger"):
        pip_launches, shapes["timed_calls"] = phase_pippenger(dev)
        by_path.update(pip_launches)
    wall("pippenger")
    by_path.update(phase_parallel(dev, ctx, shapes))
    wall("parallel")
    counted = {name: by_path[COUNTED_ON.get(name, "verify")][name] for name in REPLACES}
    shapes["table_builds"] = ctx["table_builds"] + wnla_builds
    shapes["table_builds"] += circuit_builds + entry_builds
    rows = {r["name"]: r for r in phase_kernels(dev, ctx["device_obj"].tables, counted, shapes)}
    wall("kernels")
    emit("pippenger_device", note="hand-written kernels' device ms per call, in the kernels "
         "phase's profiler session", calls=shapes["timed_calls"])
    emit("walls", seconds=walls, build_seconds=info["seconds"])
    kernels = []
    for name, (source, replaces) in REPLACES.items():
        r = rows[MAIN_ROW[name]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counted[name], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, device_ms=r.get("device_ms"), shape=r["shape"],
            plain_B=r["plain_B"],
            counted_on=COUNTED_ON.get(name, "verify"),
            launches_by_path={p: by_path[p][name] for p in by_path},
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
