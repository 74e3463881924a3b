"""Model-level entry points: ready-made protocol instances.

The system is a proof-system library; its "models" are the protocol
instantiations a user actually runs. The port carries the batched u64
range proof — prover and both verifiers — and fixture helpers to stand up
an instance and a batch of prover inputs from a seed.
"""

from typing import NamedTuple

from ..protocol.circuit import ArithmeticCircuitDevice, CircuitWitnessDev
from ..protocol.reciprocal import ReciprocalRangeProofDevice, ReciprocalWitnessDev
from ..protocol.u64 import U64RangeProofDevice
from ..protocol.wnla import WNLADevice

__all__ = [
    "ArithmeticCircuitDevice",
    "CircuitWitnessDev",
    "ProveBatch",
    "ReciprocalRangeProofDevice",
    "ReciprocalWitnessDev",
    "U64RangeProofDevice",
    "WNLADevice",
    "u64_fixture",
    "u64_prove_batch",
]


def u64_fixture(seed: str, B: int, device="cuda", tables="auto"):
    """Host-side setup: seeded generators -> (oracle U64RangeProof,
    U64RangeProofDevice batched over B lanes on `device`, rng).

    tables: "auto" builds fixed-base window tables at the default window
    width when `device` is a CUDA device and none on the CPU (the eager
    build is slow there); "never" skips them; an int builds them at that
    window width on either device."""
    import torch

    from ..oracle import curve as oc
    from ..oracle.u64 import U64RangeProof
    from ..ops import curve as dcv
    from ..ops.fixed_base import DEFAULT_W
    from ..protocol import convert as cv
    from ..protocol.u64 import build_u64_tables
    from ..utils.rng import SeededRng

    rng = SeededRng(seed)
    g = oc.GENERATOR.mul(rng.scalar())
    g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(16)]
    h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(32)]
    public = U64RangeProof(g=g, g_vec=g_vec, h_vec=h_vec)

    if tables == "auto":
        w_bits = DEFAULT_W if torch.device(device).type == "cuda" else None
    elif tables == "never":
        w_bits = None
    elif isinstance(tables, int) and not isinstance(tables, bool):
        w_bits = tables
    else:
        raise ValueError(f"tables must be 'auto', 'never' or a window width, got {tables!r}")

    tables_val = None
    if w_bits is not None:
        tables_val = build_u64_tables(
            dcv.from_int_points([g], squeeze=True, device=device),
            dcv.from_int_points(g_vec, device=device),
            dcv.from_int_points(h_vec, device=device),
            w_bits,
        )

    dev = U64RangeProofDevice(
        g=cv.point_batched(g, B, device=device),
        g_vec=cv.points_batched(g_vec, B, device=device),
        h_vec=cv.points_batched(h_vec, B, device=device),
        tables=tables_val,
    )
    return public, dev, rng


class ProveBatch(NamedTuple):
    """What `U64RangeProofDevice.prove` takes for B lanes, and the host
    values of the distinct lanes it was tiled from."""

    x_words: object  # (2, B) int64: (lo, hi) 32-bit halves of each value
    s: object  # (16, B) limbs: the commitments' blinding scalars
    blind: object  # (16, 52, B) limbs: the blinding stream, reference draw order
    lanes: list  # per distinct lane: dict(x=int, s=int, draws=[52 ints])


def u64_prove_batch(rng, xs, B: int, device="cuda") -> ProveBatch:
    """Prover inputs for B lanes: for every value of `xs`, a blinding
    scalar s and the 52 blinding draws are taken from `rng` in that order
    (`utils/rng.py`; an oracle prover fed `ReplayRng(draws)` makes the same
    proof), and the distinct lanes are tiled over the batch: lane b holds
    lane b % len(xs)."""
    import numpy as np
    import torch

    from ..ops import field as f
    from ..protocol import convert as cv
    from ..protocol.u64 import U64_BLIND_DRAWS

    lanes = []
    for x in xs:
        if not 0 <= x < (1 << 64):
            raise ValueError(f"{x} is not a u64 value")
        s = rng.scalar()
        lanes.append(dict(x=x, s=s, draws=rng.scalars(U64_BLIND_DRAWS)))
    words = np.array(
        [[ln["x"] & 0xFFFFFFFF for ln in lanes], [ln["x"] >> 32 for ln in lanes]],
        dtype=np.int64,
    )
    s_limbs = f.ints_to_limbs([ln["s"] for ln in lanes])  # (16, n)
    blind = cv.scalar_cols([ln["draws"] for ln in lanes])  # (16, 52, n)
    reps = -(-B // len(lanes))

    def tile(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.repeat((1,) * (t.ndim - 1) + (reps,))[..., :B].contiguous().to(device)

    return ProveBatch(x_words=tile(words), s=tile(s_limbs), blind=tile(blind), lanes=lanes)
