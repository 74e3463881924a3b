"""Model-level entry points: ready-made protocol instances.

The system is a proof-system library; its "models" are the protocol
instantiations a user actually runs. The port carries the batched u64
range proof — prover and both verifiers — the standalone weight-norm
linear argument, the standalone arithmetic circuit, and fixture helpers to
stand up an instance and a batch of prover inputs from a seed.
"""

from typing import NamedTuple

from ..protocol.circuit import ArithmeticCircuitDevice, CircuitWitnessDev
from ..protocol.reciprocal import ReciprocalRangeProofDevice, ReciprocalWitnessDev
from ..protocol.u64 import U64RangeProofDevice
from ..protocol.wnla import WNLADevice

__all__ = [
    "ArithmeticCircuitDevice",
    "CIRCUIT_DISTINCT",
    "CIRCUIT_LABEL",
    "CIRCUIT_SEED",
    "CircuitFixture",
    "CircuitWitnessDev",
    "ProveBatch",
    "ReciprocalRangeProofDevice",
    "ReciprocalWitnessDev",
    "U64RangeProofDevice",
    "WNLADevice",
    "WNLAFixture",
    "WNLA_DISTINCT",
    "WNLA_LABEL",
    "circuit_fixture",
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


# the standalone circuit's transcript label and seed (the JAX package's
# `tests/test_device_circuit.py`), the most distinct lanes a fixture makes,
# and the values of the reciprocal kind's distinct lanes
CIRCUIT_LABEL = b"circuit test"
CIRCUIT_SEED = "device ac"
CIRCUIT_DISTINCT = 4
CIRCUIT_VALUES = (0, 123456, 0xDEADBEEFCAFEBABE, 2**64 - 1)


class CircuitFixture(NamedTuple):
    """A standalone arithmetic-circuit instance over B lanes, a batch of
    prover inputs for it, and what the host knows about its distinct lanes
    (lane b holds distinct lane b % len(lanes))."""

    circuit: object  # the oracle ArithmeticCircuit
    dev: ArithmeticCircuitDevice  # the same instance over B lanes
    v: object  # PointJ (16, k, B): the lanes' commitments
    v_bytes: object  # (33, k, B) their SEC1 bytes
    witness: CircuitWitnessDev  # tiled over B
    blind: object  # (16, n_blind_draws(nv, nm), B): the blinding streams
    lanes: list  # per distinct lane: dict(witness, v, draws, proof) — oracle objects
    rng: object
    label: bytes


def _ac_works(rng):
    """The oracle's ac_works instance (the JAX package's
    `tests/test_oracle_protocols.py::make_ac_fixture`, in its draw order):
    x + y = r, x * y = z with x, y = 3, 5; one multiplication gate, so
    g_vec holds one point and g_vec_ none. -> (circuit, lane witness maker)."""
    from ..oracle import curve as oc
    from ..oracle.circuit import ArithmeticCircuit, CircuitWitness, PartitionType
    from ..oracle.field import N

    x, y, r, z = 3, 5, 8, 15
    dim_nm, dim_no, dim_nv, k = 1, 2, 2, 1
    g = oc.GENERATOR.mul(rng.scalar())
    g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(1)]
    h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(16)]

    def partition(typ, index):
        return index if typ == PartitionType.LL else None

    circuit = ArithmeticCircuit(
        dim_nm=dim_nm, dim_no=dim_no, k=k, dim_nl=dim_nv * k, dim_nv=dim_nv,
        dim_nw=2 * dim_nm + dim_no, g=g,
        g_vec=g_vec[:dim_nm], h_vec=h_vec[: 9 + dim_nv],
        W_m=[[0, 0, 1, 0]], W_l=[[0, 1, 0, 0], [0, N - 1, 1, 0]],
        a_m=[0], a_l=[(-r) % N, (-z) % N], f_l=True, f_m=False,
        g_vec_=g_vec[dim_nm:], h_vec_=h_vec[9 + dim_nv:],
        partition=partition,
    )
    return circuit, lambda j: CircuitWitness(
        v=[[x, y]], s_v=[rng.scalar()], w_l=[x], w_r=[y], w_o=[z, r])


def _reciprocal_circuit(rng):
    """The reciprocal-decomposition circuit at the u64 dims (base 16, 16
    digits: dim_nm = dim_no = 16, dim_nv = dim_nl = 17, dim_nw = 48) for
    one seeded challenge e, built by the oracle's
    `ReciprocalRangeProof.make_circuit(e)` over u64-sized generators (g,
    g_vec 16, h_vec 26 + 6 padding). The witness of value x is the one the
    reciprocal prover builds: digits, multiplicities, r = 1 / (d + e),
    v = [x] + r. -> (circuit, lane witness maker)."""
    from ..oracle import curve as oc
    from ..oracle.circuit import CircuitWitness
    from ..oracle.field import fn_add, fn_inv
    from ..oracle.reciprocal import ReciprocalRangeProof
    from ..oracle.u64 import DIM_ND, DIM_NP, H_VEC_CIRCUIT_SZ, u64_to_hex, u64_to_hex_mapped

    g = oc.GENERATOR.mul(rng.scalar())
    g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(16)]
    h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(32)]
    e = rng.scalar()
    circuit = ReciprocalRangeProof(
        dim_nd=DIM_ND, dim_np=DIM_NP, g=g, g_vec=g_vec, h_vec=h_vec[:H_VEC_CIRCUIT_SZ],
        g_vec_=[], h_vec_=h_vec[H_VEC_CIRCUIT_SZ:],
    ).make_circuit(e)

    def witness(j):
        x = CIRCUIT_VALUES[j % len(CIRCUIT_VALUES)]
        digits = u64_to_hex(x)
        r = [fn_inv(fn_add(d, e)) for d in digits]
        return CircuitWitness(v=[[x] + r], s_v=[rng.scalar()], w_l=digits, w_r=r,
                              w_o=u64_to_hex_mapped(x))

    return circuit, witness


def _circuit_tables(circuit, w_bits: int, device="cuda"):
    """Fixed-base window tables over an oracle circuit's generators:
    {'full': [g | h_vec + h_vec_ | g_vec + g_vec_], 'gv': a row view of its
    [g | g_vec] rows}. For the reciprocal circuit at the u64 dims these are
    `protocol/u64.build_u64_tables`' tables over the same generators."""
    from ..ops import curve as dcv
    from ..ops.fixed_base import build_tables

    c = circuit
    tab = build_tables(dcv.from_int_points(
        [c.g] + c.h_vec + c.h_vec_ + c.g_vec + c.g_vec_, device=device), w_bits)
    g0 = 1 + len(c.h_vec) + len(c.h_vec_)
    return {"full": tab, "gv": tab.take([0] + list(range(g0, g0 + len(c.g_vec))))}


def circuit_fixture(kind: str, B: int, device="cuda", tables="auto") -> CircuitFixture:
    """Host-side setup of a standalone arithmetic circuit over B lanes.

    kind: "ac" (the oracle's ac_works instance) or "reciprocal" (the
    reciprocal-decomposition circuit at the u64 dims). Both are lifted by
    `convert.circuit_from_oracle` without a `collect_c` override, so the
    device circuit runs the generic dense path. min(B, CIRCUIT_DISTINCT)
    distinct lanes each draw, from `SeededRng(seed)` after the instance, a
    witness (its commitment blinding s_v; the reciprocal kind also takes
    its value from CIRCUIT_VALUES) and then their blinding stream; each
    lane's oracle proof under CIRCUIT_LABEL replays that stream. The
    distinct lanes are tiled over B. For "ac", lane 0 is the JAX package's
    `tests/test_device_circuit.py` lane 0.

    tables: as for `u64_fixture` (`_circuit_tables`)."""
    import numpy as np

    from ..ops import curve as dcv
    from ..ops import field as f
    from ..oracle.merlin import Transcript as HostTranscript
    from ..protocol import convert as cv
    from ..protocol.circuit import n_blind_draws
    from ..utils.rng import ReplayRng, SeededRng

    makers = {"ac": _ac_works, "reciprocal": _reciprocal_circuit}
    if kind not in makers:
        raise ValueError(f"kind must be one of {sorted(makers)}, got {kind!r}")
    rng = SeededRng(CIRCUIT_SEED)
    circ, make_witness = makers[kind](rng)
    lanes = []
    for j in range(min(B, CIRCUIT_DISTINCT)):
        wit = make_witness(j)
        v = [circ.commit(wit.v[i], wit.s_v[i]) for i in range(circ.k)]
        draws = rng.scalars(n_blind_draws(circ.dim_nv, circ.dim_nm))
        proof = circ.prove(v, wit, HostTranscript(CIRCUIT_LABEL), ReplayRng(draws))
        lanes.append(dict(witness=wit, v=v, draws=draws, proof=proof))

    def tile(a):
        return _tile_lanes(a, B, device)

    def cols(name):
        return tile(cv.scalar_cols([getattr(ln["witness"], name) for ln in lanes]))

    wits = [ln["witness"] for ln in lanes]
    witness = CircuitWitnessDev(
        v=tile(np.stack([cv.scalar_cols([w.v[i] for w in wits]) for i in range(circ.k)], axis=1)),
        s_v=cols("s_v"), w_l=cols("w_l"), w_r=cols("w_r"), w_o=cols("w_o"),
    )
    v = dcv.PointJ(*(tile(np.stack([f.ints_to_limbs([getattr(p, a) for p in ln["v"]])
                                    for ln in lanes], axis=-1)) for a in "xyz"))
    w_bits = _table_width(tables, device)
    return CircuitFixture(
        circuit=circ,
        dev=cv.circuit_from_oracle(
            circ, B, device=device,
            tables=None if w_bits is None else _circuit_tables(circ, w_bits, device)),
        v=v, v_bytes=tile(cv.compressed_cols([ln["v"] for ln in lanes])),
        witness=witness, blind=tile(cv.scalar_cols([ln["draws"] for ln in lanes])),
        lanes=lanes, rng=rng, label=CIRCUIT_LABEL,
    )
