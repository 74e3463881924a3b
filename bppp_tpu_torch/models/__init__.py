"""Model-level entry points: ready-made protocol instances.

The system is a proof-system library; its "models" are the protocol
instantiations a user actually runs. This slice of the port carries the
batched u64 range-proof verifier and a fixture helper to stand up an
instance from a seed.
"""

from ..protocol.circuit import ArithmeticCircuitDevice
from ..protocol.reciprocal import ReciprocalRangeProofDevice
from ..protocol.u64 import U64RangeProofDevice
from ..protocol.wnla import WNLADevice

__all__ = [
    "ArithmeticCircuitDevice",
    "ReciprocalRangeProofDevice",
    "U64RangeProofDevice",
    "WNLADevice",
    "u64_fixture",
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
