"""The reference's work, as jobs a pool of host processes runs.

Each job takes plain Python values (seed strings, ints, wire lanes) and
imports nothing but `bench_port.reference`. The pool uses the `spawn`
start method; every worker ends before `run` returns. Workers touch no
card.
"""

from __future__ import annotations

import multiprocessing
import os

from ..reference import instances, wire
from ..reference.field import fn_mul
from ..reference.merlin import Transcript
from ..reference.rng import ReplayRng, SeededRng
from ..reference.wnla import WNLA

_PUBLIC: dict = {}


def _u64_public(seed: str):
    if seed not in _PUBLIC:
        _PUBLIC[seed] = instances.u64_public(seed)
    return _PUBLIC[seed]


def _wnla_gens(seed: str, sz_l: int, sz_n: int):
    key = (seed, sz_l, sz_n)
    if key not in _PUBLIC:
        _PUBLIC[key] = instances.wnla_generators(seed, sz_l, sz_n)
    return _PUBLIC[key]


def u64_honest_proof(seed: str, label: bytes, x: int, index: int) -> dict:
    """An honest proof of value x in wire form, its blinding s and draws
    from `SeededRng(f"{seed} proof {index}")`."""
    public = _u64_public(seed)
    rng = SeededRng(f"{seed} proof {index}")
    s = rng.scalar()
    proof = public.prove(x, s, Transcript(label), rng)
    return wire.u64_to_lane(public.commit_value(x, s), proof)


def u64_verdict(seed: str, label: bytes, lane: dict) -> bool:
    return wire.verify_u64_lane(_u64_public(seed), lane, label)


def u64_prove(seed: str, label: bytes, x: int, s: int, draws: list) -> dict:
    """The commitment and proof of one prover lane, its draws replayed."""
    public = _u64_public(seed)
    proof = public.prove(x, s, Transcript(label), ReplayRng(draws))
    return wire.u64_to_lane(public.commit_value(x, s), proof)


def wnla_commit_prove(seed: str, label: bytes, c: list, rho: int, l: list, n: list,
                      mu: int | None = None) -> dict:
    """The commitment and proof of one WNLA lane; mu = rho^2 unless given."""
    g, g_vec, h_vec = _wnla_gens(seed, len(l), len(n))
    mu = fn_mul(rho, rho) if mu is None else mu
    w = WNLA(g=g, g_vec=g_vec, h_vec=h_vec, c=c, rho=rho, mu=mu)
    com = w.commit(l, n)
    lane = wire.wnla_to_lane(w.prove(com, Transcript(label), l, n))
    lane["com"] = com.to_bytes()
    return lane


def _call(job):
    fn, args = job
    return globals()[fn](*args)


def run(fn: str, arglist: list, procs: int | None = None) -> list:
    """[fn(*args) for args in arglist], spread over host processes."""
    jobs = [(fn, tuple(a)) for a in arglist]
    procs = min(procs or os.cpu_count() or 1, 8, len(jobs))
    if procs <= 1:
        return [_call(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs) as pool:
        out = pool.map(_call, jobs, chunksize=1)
        pool.close()
        pool.join()
    return out
