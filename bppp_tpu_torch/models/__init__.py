"""Model-level entry points: ready-made protocol instances.

The system is a proof-system library; its "models" are the protocol
instantiations a user actually runs. The port carries the batched u64
range proof — prover and both verifiers — the standalone weight-norm
linear argument, and fixture helpers to stand up an instance and a batch
of prover inputs from a seed.
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
    "WNLAFixture",
    "WNLA_DISTINCT",
    "WNLA_LABEL",
    "u64_fixture",
    "u64_prove_batch",
    "wnla_fixture",
]


def _table_width(tables, device):
    """The window width `tables` asks for: "auto" -> the default width on
    a CUDA device and None on the CPU (the eager build is slow there),
    "never" -> None, an int -> that width."""
    import torch

    from ..ops.fixed_base import DEFAULT_W

    if tables == "auto":
        return DEFAULT_W if torch.device(device).type == "cuda" else None
    if tables == "never":
        return None
    if isinstance(tables, int) and not isinstance(tables, bool):
        return tables
    raise ValueError(f"tables must be 'auto', 'never' or a window width, got {tables!r}")


def _tile_lanes(a, B: int, device):
    """(..., n) int64 array of n distinct lanes -> (..., B) int64 tensor on
    `device` in which lane b holds lane b % n."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    reps = -(-B // t.shape[-1])
    return t.repeat((1,) * (t.ndim - 1) + (reps,))[..., :B].contiguous().to(device)


def u64_fixture(seed: str, B: int, device="cuda", tables="auto"):
    """Host-side setup: seeded generators -> (oracle U64RangeProof,
    U64RangeProofDevice batched over B lanes on `device`, rng).

    tables: "auto" builds fixed-base window tables at the default window
    width when `device` is a CUDA device and none on the CPU (the eager
    build is slow there); "never" skips them; an int builds them at that
    window width on either device."""
    from ..oracle import curve as oc
    from ..oracle.u64 import U64RangeProof
    from ..ops import curve as dcv
    from ..protocol import convert as cv
    from ..protocol.u64 import build_u64_tables
    from ..utils.rng import SeededRng

    rng = SeededRng(seed)
    g = oc.GENERATOR.mul(rng.scalar())
    g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(16)]
    h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(32)]
    public = U64RangeProof(g=g, g_vec=g_vec, h_vec=h_vec)
    w_bits = _table_width(tables, device)

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
    return ProveBatch(x_words=_tile_lanes(words, B, device), s=_tile_lanes(s_limbs, B, device),
                      blind=_tile_lanes(blind, B, device), lanes=lanes)


# the JAX package's WNLA size tests (`tests/test_device_wnla_sizes.py::_build`):
# distinct lanes per instance family, and the transcript label of their proofs
WNLA_DISTINCT = 2
WNLA_LABEL = b"wnla test"


class WNLAFixture(NamedTuple):
    """A standalone WNLA instance family over B lanes and what the host
    knows about its distinct lanes."""

    lanes: list  # per distinct lane: dict(wnla, l, n, com, proof) — oracle objects
    dev: WNLADevice  # batched over B lanes; lane b holds distinct lane b % len(lanes)
    l: object  # (16, sz_l, B) int64 limbs
    n: object  # (16, sz_n, B)
    com: object  # PointJ (16, B): the lanes' commitments
    label: bytes  # the transcript label of the oracle proofs


def wnla_fixture(seed: str, sz_l: int, sz_n: int, B: int, device="cuda",
                 tables="auto") -> WNLAFixture:
    """Host-side setup of a standalone WNLA at |l| = sz_l, |n| = sz_n:
    seeded generators g, g_vec (sz_n), h_vec (sz_l); per distinct lane a
    public c (sz_l), rho, mu = rho^2 and a witness l, n, all drawn from
    `SeededRng(seed)` in the order of the JAX package's
    `tests/test_device_wnla_sizes.py::_build`; each lane's commitment and
    its oracle proof under `WNLA_LABEL`. The `WNLA_DISTINCT` distinct lanes
    are tiled over B.

    tables: as for `u64_fixture` — fixed-base window tables over
    [g | h_vec | g_vec] for `verify_fast` and the fast prover."""
    from ..ops import curve as dcv
    from ..ops import field as f
    from ..ops.fixed_base import build_tables
    from ..oracle import curve as oc
    from ..oracle.field import fn_mul
    from ..oracle.merlin import Transcript as HostTranscript
    from ..oracle.wnla import WNLA
    from ..protocol import convert as cv
    from ..utils.rng import SeededRng

    rng = SeededRng(seed)
    g = oc.GENERATOR.mul(rng.scalar())
    g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(sz_n)]
    h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(sz_l)]
    lanes = []
    for _ in range(WNLA_DISTINCT):
        c = rng.scalars(sz_l)
        rho = rng.scalar()
        l = rng.scalars(sz_l)
        n = rng.scalars(sz_n)
        wnla = WNLA(g=g, g_vec=g_vec, h_vec=h_vec, c=c, rho=rho, mu=fn_mul(rho, rho))
        com = wnla.commit(l, n)
        proof = wnla.prove(com, HostTranscript(WNLA_LABEL), l, n)
        lanes.append(dict(wnla=wnla, l=l, n=n, com=com, proof=proof))

    def tile(a):
        return _tile_lanes(a, B, device)

    w_bits = _table_width(tables, device)
    tab = None
    if w_bits is not None:
        tab = build_tables(dcv.from_int_points([g] + h_vec + g_vec, device=device), w_bits)
    dev = WNLADevice(
        g=cv.point_batched(g, B, device=device),
        g_vec=cv.points_batched(g_vec, B, device=device),
        h_vec=cv.points_batched(h_vec, B, device=device),
        c_vec=tile(cv.scalar_cols([ln["wnla"].c for ln in lanes])),
        rho=tile(f.ints_to_limbs([ln["wnla"].rho for ln in lanes])),
        mu=tile(f.ints_to_limbs([ln["wnla"].mu for ln in lanes])),
        tables=tab,
    )
    com = dcv.PointJ(*(tile(f.ints_to_limbs([getattr(ln["com"], a) for ln in lanes]))
                       for a in "xyz"))
    return WNLAFixture(
        lanes=lanes, dev=dev,
        l=tile(cv.scalar_cols([ln["l"] for ln in lanes])),
        n=tile(cv.scalar_cols([ln["n"] for ln in lanes])),
        com=com, label=WNLA_LABEL,
    )
