"""The program's surface as the benchmark sees it: the port `bppp_tpu_torch`.

This is where the harness imports the port. It loads the port's kernels,
reads its launch counters (`LAUNCHES`, `PLAIN_CALLS` of `ops/cuda_*.py`),
takes the names of its hand-written kernels from its CUDA sources, and, in
a traced run, notes what each launch of a kernel wrapper was given, so
that `metrics/_work.py` can count the work.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import re
import time

from . import registry

PORT = "bppp_tpu_torch"
COUNTER_MODULES = ("cuda_keccak", "cuda_msm", "cuda_fixed_base", "cuda_curve", "cuda_ladder")


def _ops(name: str):
    return importlib.import_module(f"{PORT}.ops.{name}")


def load_kernels() -> float:
    """Build (first run of a checkout) or load every kernel library; the
    seconds it took. The libraries live in the port's own fixed cache,
    `bppp_tpu_torch/_build/<hash>/`, inside the checkout."""
    t0 = time.perf_counter()
    b = _ops("_build")
    b.build_all()
    for name in b.SOURCES:
        b.lib(name)
    return time.perf_counter() - t0


def hand_written_names() -> frozenset:
    """The `__global__` functions of the port's CUDA sources."""
    csrc = os.path.join(registry.ROOT, PORT, "csrc")
    names = set()
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fn)) as fh:
                names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                        fh.read()))
    return frozenset(names)


def reset_counts() -> None:
    for m in COUNTER_MODULES:
        mod = _ops(m)
        for d in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k in d:
                d[k] = 0


def read_counts() -> tuple:
    launches, plain = {}, {}
    for m in COUNTER_MODULES:
        mod = _ops(m)
        launches.update(mod.LAUNCHES)
        plain.update(mod.PLAIN_CALLS)
    return launches, plain


def _counting(orig, count, name: str, log: list):
    """`orig` that first notes a launch's work, when its operands lie on a card
    (a CPU tensor runs the wrapper's plain version, no kernel)."""

    def wrapped(*args, **kwargs):
        first = args[0] if args else None
        if getattr(first, "is_cuda", False) or getattr(getattr(first, "words", None), "is_cuda", False):
            log.append((name,) + tuple(count(*args, **kwargs)))
        return orig(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def launch_log(log: list):
    """Within the block, append (wrapper, int32 operations, bytes) for
    every kernel launch through a wrapper that `metrics/_work.py` counts."""
    work = registry.metric("_work")
    saved = []
    for mod_name, fns in work.WRAPPERS.items():
        mod = _ops(mod_name)
        for fn_name in fns:
            orig = getattr(mod, fn_name)
            saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, _counting(orig, getattr(work, fn_name), fn_name, log))
    try:
        yield log
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


# -- the port's containers <-> wire arrays (dicts keyed as `harness.lanes`) --


def u64_proof_bytes(t: dict):
    """Wire tensors -> (commitment bytes, `ReciprocalProofBytes`)."""
    from bppp_tpu_torch.protocol.circuit import CircuitProofBytes
    from bppp_tpu_torch.protocol.reciprocal import ReciprocalProofBytes
    from bppp_tpu_torch.protocol.wnla import WNLAProofBytes

    w = WNLAProofBytes(r=t["wnla_r"], x=t["wnla_x"], l=t["wnla_l"], n=t["wnla_n"])
    c = CircuitProofBytes(c_l=t["c_l"], c_r=t["c_r"], c_o=t["c_o"], c_s=t["c_s"], wnla=w)
    return t["com"], ReciprocalProofBytes(circuit=c, r=t["r"])


def u64_wire(com, proof) -> dict:
    """A u64 prover's outputs (commitment point, `ReciprocalProofDev`) ->
    wire tensors on the card."""
    from bppp_tpu_torch.ops.curve import compress
    from bppp_tpu_torch.protocol.convert import reciprocal_dev_to_bytes

    pb = reciprocal_dev_to_bytes(proof)
    w = pb.circuit.wnla
    return dict(com=compress(com), c_l=pb.circuit.c_l, c_r=pb.circuit.c_r, c_o=pb.circuit.c_o,
                c_s=pb.circuit.c_s, r=pb.r, wnla_r=w.r, wnla_x=w.x, wnla_l=w.l, wnla_n=w.n)


def wnla_wire(com, proof) -> dict:
    from bppp_tpu_torch.ops.curve import compress
    from bppp_tpu_torch.protocol.convert import wnla_dev_to_bytes

    w = wnla_dev_to_bytes(proof)
    return dict(com=compress(com), wnla_r=w.r, wnla_x=w.x, wnla_l=w.l, wnla_n=w.n)
