"""JSON proof interchange matching the reference's serde conventions.

The reference derives serde on `SerializableProof` twins holding k256
`AffinePoint` / `Scalar` (wnla.rs:33-61, circuit.rs:36-76,
reciprocal.rs:37-59); serde_json is exercised in tests.rs:38,132. k256's
human-readable encoding (serdect) is:

  * AffinePoint -> lowercase hex of the SEC1 compressed encoding
    (33 bytes -> 66 chars; the identity encodes as the 1-byte "00")
  * Scalar     -> lowercase hex of the 32-byte big-endian repr

Field names match the Rust structs exactly so JSON round-trips between
the two implementations.
"""

from __future__ import annotations

import json

from . import curve
from .circuit import CircuitProof
from .field import N
from .reciprocal import ReciprocalProof
from .wnla import WNLAProof


def point_to_hex(p: curve.Point) -> str:
    if p.is_identity():
        return "00"
    return p.to_bytes().hex()


def point_from_hex(s: str) -> curve.Point:
    data = bytes.fromhex(s)
    if data == b"\x00":
        return curve.IDENTITY
    return curve.from_bytes(data)


def scalar_to_hex(x: int) -> str:
    return (x % N).to_bytes(32, "big").hex()


def scalar_from_hex(s: str) -> int:
    x = int.from_bytes(bytes.fromhex(s), "big")
    if x >= N:
        raise ValueError("scalar out of range")
    return x


# -- WNLA ------------------------------------------------------------------

def wnla_proof_to_dict(p: WNLAProof) -> dict:
    return {
        "r": [point_to_hex(q) for q in p.r],
        "x": [point_to_hex(q) for q in p.x],
        "l": [scalar_to_hex(v) for v in p.l],
        "n": [scalar_to_hex(v) for v in p.n],
    }


def wnla_proof_from_dict(d: dict) -> WNLAProof:
    return WNLAProof(
        r=[point_from_hex(s) for s in d["r"]],
        x=[point_from_hex(s) for s in d["x"]],
        l=[scalar_from_hex(s) for s in d["l"]],
        n=[scalar_from_hex(s) for s in d["n"]],
    )


# -- circuit ----------------------------------------------------------------

def circuit_proof_to_dict(p: CircuitProof) -> dict:
    return {
        "c_l": point_to_hex(p.c_l),
        "c_r": point_to_hex(p.c_r),
        "c_o": point_to_hex(p.c_o),
        "c_s": point_to_hex(p.c_s),
        "r": [point_to_hex(q) for q in p.r],
        "x": [point_to_hex(q) for q in p.x],
        "l": [scalar_to_hex(v) for v in p.l],
        "n": [scalar_to_hex(v) for v in p.n],
    }


def circuit_proof_from_dict(d: dict) -> CircuitProof:
    return CircuitProof(
        c_l=point_from_hex(d["c_l"]),
        c_r=point_from_hex(d["c_r"]),
        c_o=point_from_hex(d["c_o"]),
        c_s=point_from_hex(d["c_s"]),
        r=[point_from_hex(s) for s in d["r"]],
        x=[point_from_hex(s) for s in d["x"]],
        l=[scalar_from_hex(s) for s in d["l"]],
        n=[scalar_from_hex(s) for s in d["n"]],
    )


# -- reciprocal / u64 ---------------------------------------------------------

def reciprocal_proof_to_dict(p: ReciprocalProof) -> dict:
    return {
        "circuit_proof": circuit_proof_to_dict(p.circuit_proof),
        "r": point_to_hex(p.r),
    }


def reciprocal_proof_from_dict(d: dict) -> ReciprocalProof:
    return ReciprocalProof(
        circuit_proof=circuit_proof_from_dict(d["circuit_proof"]),
        r=point_from_hex(d["r"]),
    )


def dumps(proof) -> str:
    if isinstance(proof, ReciprocalProof):
        return json.dumps(reciprocal_proof_to_dict(proof))
    if isinstance(proof, CircuitProof):
        return json.dumps(circuit_proof_to_dict(proof))
    if isinstance(proof, WNLAProof):
        return json.dumps(wnla_proof_to_dict(proof))
    raise TypeError(type(proof))


def loads_reciprocal(s: str) -> ReciprocalProof:
    return reciprocal_proof_from_dict(json.loads(s))


def loads_circuit(s: str) -> CircuitProof:
    return circuit_proof_from_dict(json.loads(s))


def loads_wnla(s: str) -> WNLAProof:
    return wnla_proof_from_dict(json.loads(s))
