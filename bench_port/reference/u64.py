"""u64 range proof (hex-digit instantiation), host oracle.

Fixed instantiation of the reciprocal protocol (reference:
src/ of the Rust reference: range_proof/u64_proof.rs): base 16, 16 hex digits =>
dims nm=16, np=16, nv=17; h_vec = 26 circuit + 6 WNLA padding = 32;
g_vec = 16 (no padding). Proof: 13 group elements + 3 scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

from .curve import Point
from .merlin import Transcript
from .reciprocal import ReciprocalProof, ReciprocalRangeProof, ReciprocalWitness

G_VEC_FULL_SZ = 16
H_VEC_CIRCUIT_SZ = 26
H_VEC_FULL_SZ = 32

DIM_ND = 16  # hex digits of a u64
DIM_NP = 16  # base


@dataclass
class U64RangeProof:
    g: Point
    g_vec: list[Point]   # 16
    h_vec: list[Point]   # 32

    def _reciprocal(self) -> ReciprocalRangeProof:
        return ReciprocalRangeProof(
            dim_nd=DIM_ND,
            dim_np=DIM_NP,
            g=self.g,
            g_vec=list(self.g_vec),
            h_vec=self.h_vec[:H_VEC_CIRCUIT_SZ],
            g_vec_=[],
            h_vec_=self.h_vec[H_VEC_CIRCUIT_SZ:],
        )

    def commit_value(self, x: int, s: int) -> Point:
        return self.g.mul(x).add(self.h_vec[0].mul(s))

    def verify(self, v: Point, proof: ReciprocalProof, t: Transcript) -> bool:
        return self._reciprocal().verify(v, proof, t)

    def prove(self, x: int, s: int, t: Transcript, rng) -> ReciprocalProof:
        assert 0 <= x < 2**64
        witness = ReciprocalWitness(
            x=x, s=s, m=u64_to_hex_mapped(x), digits=u64_to_hex(x)
        )
        reciprocal = self._reciprocal()
        return reciprocal.prove(
            reciprocal.commit_value(witness.x, witness.s), witness, t, rng
        )


def u64_to_hex(x: int) -> list[int]:
    """16 hex digits, least-significant first (u64_proof.rs:84-90)."""
    out = []
    for _ in range(16):
        out.append(x % 16)
        x //= 16
    return out


def u64_to_hex_mapped(x: int) -> list[int]:
    """Digit multiplicities: out[d] = count of hex digit d (u64_proof.rs:92-102)."""
    out = [0] * 16
    for _ in range(16):
        out[x % 16] += 1
        x //= 16
    return out
