"""Proofs in wire form, lane by lane, for the reference.

A lane of a u64 range proof is a dict of Python values:
`com`, `c_l`, `c_r`, `c_o`, `c_s`, `r` (33 bytes each: SEC1 compressed, the
identity as 33 zero bytes), `wnla_r`, `wnla_x` (lists of 33-byte strings,
innermost round first) and `wnla_l`, `wnla_n` (lists of 16-tuples of
16-bit limbs, least significant first). A WNLA lane has `com`, `wnla_r`,
`wnla_x`, `wnla_l` and `wnla_n`. Decoding follows the reference's
deserialisation: a point must carry tag 2 or 3 with x below p on the
curve (or be the identity), a scalar must be below n; anything else is
no proof, and a verifier given it rejects.
"""

from __future__ import annotations

from . import curve
from .field import N
from .merlin import Transcript
from .circuit import CircuitProof
from .reciprocal import ReciprocalProof
from .wnla import WNLAProof

POINT_FIELDS = ("c_l", "c_r", "c_o", "c_s", "r")


class Malformed(ValueError):
    """A lane whose bytes do not decode to a proof."""


def limbs_to_int(limbs) -> int:
    out = 0
    for i, v in enumerate(limbs):
        v = int(v)
        if not 0 <= v < 1 << 16:
            raise Malformed("limb out of range")
        out |= v << (16 * i)
    return out


def int_to_limbs(x: int) -> tuple:
    return tuple((x >> (16 * i)) & 0xFFFF for i in range(16))


def point_to_bytes(p: curve.Point) -> bytes:
    return p.to_bytes()


def point_from_bytes(b: bytes) -> curve.Point:
    try:
        return curve.from_bytes(bytes(b))
    except ValueError as e:
        raise Malformed(str(e)) from None


def scalar_from_limbs(limbs) -> int:
    x = limbs_to_int(limbs)
    if x >= N:
        raise Malformed("scalar out of range")
    return x


def wnla_to_lane(p: WNLAProof) -> dict:
    return dict(wnla_r=[q.to_bytes() for q in p.r], wnla_x=[q.to_bytes() for q in p.x],
                wnla_l=[int_to_limbs(v) for v in p.l], wnla_n=[int_to_limbs(v) for v in p.n])


def wnla_from_lane(lane: dict) -> WNLAProof:
    return WNLAProof(r=[point_from_bytes(b) for b in lane["wnla_r"]],
                     x=[point_from_bytes(b) for b in lane["wnla_x"]],
                     l=[scalar_from_limbs(v) for v in lane["wnla_l"]],
                     n=[scalar_from_limbs(v) for v in lane["wnla_n"]])


def u64_to_lane(com: curve.Point, proof: ReciprocalProof) -> dict:
    cp = proof.circuit_proof
    lane = dict(com=com.to_bytes(), c_l=cp.c_l.to_bytes(), c_r=cp.c_r.to_bytes(),
                c_o=cp.c_o.to_bytes(), c_s=cp.c_s.to_bytes(), r=proof.r.to_bytes())
    lane.update(wnla_to_lane(WNLAProof(r=cp.r, x=cp.x, l=cp.l, n=cp.n)))
    return lane


def u64_from_lane(lane: dict) -> tuple:
    """-> (commitment, ReciprocalProof); raises Malformed."""
    w = wnla_from_lane(lane)
    pts = {k: point_from_bytes(lane[k]) for k in POINT_FIELDS}
    cp = CircuitProof(c_l=pts["c_l"], c_r=pts["c_r"], c_o=pts["c_o"], c_s=pts["c_s"],
                      r=w.r, x=w.x, l=w.l, n=w.n)
    return point_from_bytes(lane["com"]), ReciprocalProof(circuit_proof=cp, r=pts["r"])


def verify_u64_lane(public, lane: dict, label: bytes) -> bool:
    """The reference's verdict on one lane in wire form: False for bytes
    that are no proof, else `U64RangeProof.verify`."""
    try:
        com, proof = u64_from_lane(lane)
    except Malformed:
        return False
    return public.verify(com, proof, Transcript(label))
