"""Weight-norm linear argument (WNLA), host oracle.

Protocol semantics match src/ of the Rust reference: wnla.rs exactly:
recursive log-halving folding argument proving knowledge of l, n with

    C = v*g + <h_vec, l> + <g_vec, n>,   v = |n|^2_mu + <c, l>

Per round (wnla.rs:125-190): even/odd split, cross terms X/R, transcript
absorb (wnla_com, wnla_x, wnla_r, l.sz, n.sz), challenge y, fold with
(rho, mu) -> (mu, mu^2). X/R are pushed after recursion, so proof.r/x are
ordered innermost-first and the verifier consumes from the END
(wnla.rs:187-189, verify at :89-90,113-118). Base case |l|+|n| < 6 emits
l, n in the clear (wnla.rs:126-133).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .curve import Point
from .field import fn_inv, fn_mul, fn_sub
from .merlin import Transcript, app_point, get_challenge
from .vectors import (
    p_vector_mul,
    reduce_vec,
    s_vector_add,
    s_vector_mul,
    s_vector_mul_on_scalar,
    s_weight_vector_mul,
)


@dataclass
class WNLAProof:
    r: list[Point] = field(default_factory=list)
    x: list[Point] = field(default_factory=list)
    l: list[int] = field(default_factory=list)
    n: list[int] = field(default_factory=list)


@dataclass
class WNLA:
    g: Point
    g_vec: list[Point]
    h_vec: list[Point]
    c: list[int]
    rho: int
    mu: int

    def commit(self, l: list[int], n: list[int]) -> Point:
        v = (s_vector_mul(self.c, l) + s_weight_vector_mul(n, n, self.mu)) % _N
        return (
            self.g.mul(v)
            .add(p_vector_mul(self.h_vec, l))
            .add(p_vector_mul(self.g_vec, n))
        )

    def _fold_public(self, y: int):
        c0, c1 = reduce_vec(self.c)
        g0, g1 = reduce_vec(self.g_vec)
        h0, h1 = reduce_vec(self.h_vec)
        from .vectors import p_vector_add, p_vector_mul_on_scalar

        h_ = p_vector_add(h0, p_vector_mul_on_scalar(h1, y))
        g_ = p_vector_add(
            p_vector_mul_on_scalar(g0, self.rho), p_vector_mul_on_scalar(g1, y)
        )
        c_ = s_vector_add(c0, s_vector_mul_on_scalar(c1, y))
        return WNLA(
            g=self.g,
            g_vec=g_,
            h_vec=h_,
            c=c_,
            rho=self.mu,
            mu=fn_mul(self.mu, self.mu),
        )

    def verify(self, commitment: Point, t: Transcript, proof: WNLAProof) -> bool:
        if len(proof.x) != len(proof.r):
            return False
        if not proof.x:
            return commitment.eq(self.commit(proof.l, proof.n))

        app_point(b"wnla_com", commitment, t)
        app_point(b"wnla_x", proof.x[-1], t)
        app_point(b"wnla_r", proof.r[-1], t)
        t.append_u64(b"l.sz", len(self.h_vec))
        t.append_u64(b"n.sz", len(self.g_vec))
        y = get_challenge(b"wnla_challenge", t)

        wnla = self._fold_public(y)
        com_ = (
            commitment.add(proof.x[-1].mul(y))
            .add(proof.r[-1].mul(fn_sub(fn_mul(y, y), 1)))
        )
        rest = WNLAProof(r=proof.r[:-1], x=proof.x[:-1], l=proof.l, n=proof.n)
        return wnla.verify(com_, t, rest)

    def prove(
        self, commitment: Point, t: Transcript, l: list[int], n: list[int]
    ) -> WNLAProof:
        if len(l) + len(n) < 6:
            return WNLAProof(r=[], x=[], l=list(l), n=list(n))

        rho_inv = fn_inv(self.rho)
        c0, c1 = reduce_vec(self.c)
        l0, l1 = reduce_vec(l)
        n0, n1 = reduce_vec(n)
        g0, g1 = reduce_vec(self.g_vec)
        h0, h1 = reduce_vec(self.h_vec)
        mu2 = fn_mul(self.mu, self.mu)

        vx = (
            fn_mul(s_weight_vector_mul(n0, n1, mu2), fn_mul(rho_inv, 2))
            + s_vector_mul(c0, l1)
            + s_vector_mul(c1, l0)
        ) % _N
        vr = (s_weight_vector_mul(n1, n1, mu2) + s_vector_mul(c1, l1)) % _N

        x_pt = (
            self.g.mul(vx)
            .add(p_vector_mul(h0, l1))
            .add(p_vector_mul(h1, l0))
            .add(p_vector_mul(g0, s_vector_mul_on_scalar(n1, self.rho)))
            .add(p_vector_mul(g1, s_vector_mul_on_scalar(n0, rho_inv)))
        )
        r_pt = (
            self.g.mul(vr).add(p_vector_mul(h1, l1)).add(p_vector_mul(g1, n1))
        )

        app_point(b"wnla_com", commitment, t)
        app_point(b"wnla_x", x_pt, t)
        app_point(b"wnla_r", r_pt, t)
        t.append_u64(b"l.sz", len(l))
        t.append_u64(b"n.sz", len(n))
        y = get_challenge(b"wnla_challenge", t)

        wnla = self._fold_public(y)
        l_ = s_vector_add(l0, s_vector_mul_on_scalar(l1, y))
        n_ = s_vector_add(
            s_vector_mul_on_scalar(n0, rho_inv), s_vector_mul_on_scalar(n1, y)
        )

        # NOTE: prover recomputes the folded commitment from scratch
        # (wnla.rs:186) rather than folding C + yX + (y^2-1)R; the verifier
        # folds (wnla.rs:100-102). Both agree; keep prover semantics.
        proof = wnla.prove(wnla.commit(l_, n_), t, l_, n_)
        proof.r.append(r_pt)
        proof.x.append(x_pt)
        return proof


_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
