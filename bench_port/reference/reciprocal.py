"""Reciprocal range proof, host oracle.

Protocol semantics match src/ of the Rust reference: range_proof/reciprocal.rs:
proves a committed value x lies in [0, base^digits). Draws challenge e,
computes reciprocals r_i = (d_i + e)^-1, commits the poles vector R, and
derives an arithmetic circuit from e (make_circuit, reciprocal.rs:150-214):

  * W_m enforces r_i * (d_i + e) = 1   (as d_i*r_i = 1 - e*r_i)
  * W_l row 0 enforces x = sum base^i * d_i
  * W_l rows 1..nd+1 enforce the pole-multiplicity identity against the
    public poles -1/(e+j) and multiplicities m

Circuit commitment = V + R (reciprocal.rs:104/141): commit_value +
commit_poles == circuit.commit([x || r], s + r_blind).
"""

from __future__ import annotations

from dataclasses import dataclass

from .circuit import (
    ArithmeticCircuit,
    CircuitProof,
    CircuitWitness,
    PartitionType,
)
from .curve import Point
from .field import fn_add, fn_inv, fn_mul
from .merlin import Transcript, app_point, get_challenge
from .vectors import p_vector_mul, s_minus, s_pow


@dataclass
class ReciprocalWitness:
    x: int                 # value in [0, base^digits)
    s: int                 # blinding
    m: list[int]           # digit multiplicities (dim_np)
    digits: list[int]      # digits (dim_nd)


@dataclass
class ReciprocalProof:
    circuit_proof: CircuitProof
    r: Point               # poles commitment


@dataclass
class ReciprocalRangeProof:
    dim_nd: int            # digit count (= dim_nm); dim_nv = dim_nd + 1
    dim_np: int            # base (= dim_no)
    g: Point
    g_vec: list[Point]     # dim_nm
    h_vec: list[Point]     # dim_nv + 9
    g_vec_: list[Point]    # WNLA padding
    h_vec_: list[Point]    # WNLA padding

    def commit_value(self, x: int, s: int) -> Point:
        return self.g.mul(x).add(self.h_vec[0].mul(s))

    def commit_poles(self, r: list[int], s: int) -> Point:
        return self.h_vec[0].mul(s).add(p_vector_mul(self.h_vec[9:], r))

    def verify(self, commitment: Point, proof: ReciprocalProof, t: Transcript) -> bool:
        app_point(b"reciprocal_commitment", commitment, t)
        e = get_challenge(b"reciprocal_challenge", t)
        circuit = self.make_circuit(e)
        circuit_commitment = commitment.add(proof.r)
        return circuit.verify([circuit_commitment], t, proof.circuit_proof)

    def prove(
        self, commitment: Point, witness: ReciprocalWitness, t: Transcript, rng
    ) -> ReciprocalProof:
        app_point(b"reciprocal_commitment", commitment, t)
        e = get_challenge(b"reciprocal_challenge", t)

        # r_i = (d_i + e)^-1, inverted one by one as the reference does (reciprocal.rs:117-119).
        r = [fn_inv(fn_add(witness.digits[i], e)) for i in range(self.dim_nd)]

        r_blind = rng.scalar()
        r_com = self.commit_poles(r, r_blind)

        v = [witness.x] + r
        circuit = self.make_circuit(e)
        circuit_witness = CircuitWitness(
            v=[v],
            s_v=[fn_add(witness.s, r_blind)],
            w_l=list(witness.digits),
            w_r=r,
            w_o=list(witness.m),
        )
        circuit_commitment = circuit.commit(circuit_witness.v[0], circuit_witness.s_v[0])
        return ReciprocalProof(
            circuit_proof=circuit.prove([circuit_commitment], circuit_witness, t, rng),
            r=r_com,
        )

    def make_circuit(self, e: int) -> ArithmeticCircuit:
        """Deterministic challenge -> circuit synthesis (reciprocal.rs:150-214).
        Pure function of e; both prover and verifier call it."""
        dim_nm = self.dim_nd
        dim_no = self.dim_np
        dim_nv = self.dim_nd + 1
        dim_nl = dim_nv
        dim_nw = self.dim_nd * 2 + self.dim_np

        a_m = [1] * dim_nm

        W_m = [[0] * dim_nw for _ in range(dim_nm)]
        for i in range(dim_nm):
            W_m[i][i + dim_nm] = s_minus(e)

        a_l = [0] * dim_nl
        base = self.dim_np

        W_l = [[0] * dim_nw for _ in range(dim_nl)]
        for i in range(dim_nm):
            W_l[0][i] = s_minus(s_pow(base, i))
        for i in range(dim_nm):
            for j in range(dim_nm):
                W_l[i + 1][j + dim_nm] = 1
        for i in range(dim_nm):
            W_l[i + 1][i + dim_nm] = 0
        for i in range(dim_nm):
            for j in range(dim_no):
                W_l[i + 1][j + 2 * dim_nm] = s_minus(fn_inv(fn_add(e, j)))

        dim_np = self.dim_np

        def partition(typ: PartitionType, index: int):
            if typ == PartitionType.LL and index < dim_np:
                return index
            return None

        return ArithmeticCircuit(
            dim_nm=dim_nm,
            dim_no=dim_no,
            k=1,
            dim_nl=dim_nl,
            dim_nv=dim_nv,
            dim_nw=dim_nw,
            g=self.g,
            g_vec=list(self.g_vec),
            h_vec=list(self.h_vec),
            W_m=W_m,
            W_l=W_l,
            a_m=a_m,
            a_l=a_l,
            f_l=True,
            f_m=False,
            g_vec_=list(self.g_vec_),
            h_vec_=list(self.h_vec_),
            partition=partition,
        )
