"""Bulletproofs++ arithmetic-circuit protocol, host oracle.

Protocol semantics match src/ of the Rust reference: circuit.rs exactly: proves
that the witness w = w_l || w_r || w_o satisfies

    w_l o w_r = W_m * w + a_m          (multiplicative constraints)
    W_l * w + sum-of-committed-v + a_l = 0   (linear constraints)

against k committed vectors v. Commits C_L, C_R, C_O, draws rho, lambda,
beta, delta, builds the blinded f(tau) polynomial (nonzero coefficients
at tau^{-2,-1,0,1,2,4,5,6}; the tau^3 slot carries the value), commits
C_S, draws tau, and folds everything into ONE WNLA instance
(circuit.rs:535-544).

RNG: every blinding lane is drawn via `rng.scalar()` in the exact
sequence the reference draws `Scalar::generate_biased` (circuit.rs:264-298
ro/rl/rr with fixed zero lanes, then ls, then ns at :371-372) so that a
replayed RNG reproduces reference proofs byte-for-byte.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional

from .curve import Point
from .field import N, fn_add, fn_inv, fn_mul, fn_sub
from .merlin import Transcript, app_point, get_challenge
from .vectors import (
    diag_inv,
    e_powers,
    p_vector_mul,
    s_minus,
    s_pow,
    s_vector_add,
    s_vector_mul,
    s_vector_mul_on_matrix,
    s_vector_mul_on_scalar,
    s_vector_sub,
    s_vector_tensor_mul,
    s_weight_vector_mul,
)
from .wnla import WNLA, WNLAProof


class PartitionType(enum.Enum):
    LO = 0
    LL = 1
    LR = 2
    NO = 3


Partition = Callable[[PartitionType, int], Optional[int]]


@dataclass
class CircuitProof:
    c_l: Point
    c_r: Point
    c_o: Point
    c_s: Point
    r: list[Point]
    x: list[Point]
    l: list[int]
    n: list[int]


@dataclass
class CircuitWitness:
    v: list[list[int]]     # k vectors of dim_nv
    s_v: list[int]         # k blindings
    w_l: list[int]         # dim_nm
    w_r: list[int]         # dim_nm
    w_o: list[int]         # dim_no


@dataclass
class ArithmeticCircuit:
    dim_nm: int
    dim_no: int
    k: int
    dim_nl: int            # dim_nv * k
    dim_nv: int
    dim_nw: int            # 2*dim_nm + dim_no
    g: Point
    g_vec: list[Point]     # dim_nm
    h_vec: list[Point]     # dim_nv + 9
    W_m: list[list[int]]   # dim_nm x dim_nw
    W_l: list[list[int]]   # dim_nl x dim_nw
    a_m: list[int]         # dim_nm
    a_l: list[int]         # dim_nl
    f_l: bool
    f_m: bool
    g_vec_: list[Point]    # WNLA padding
    h_vec_: list[Point]    # WNLA padding
    partition: Partition

    # -- public API ----------------------------------------------------

    def commit(self, v: list[int], s: int) -> Point:
        """C = v[0]*g + s*h_vec[0] + <h_vec[9:], v[1:]> (circuit.rs:146-151).
        Slots 1..9 of h_vec are reserved for the 9 blinding lanes."""
        return (
            self.g.mul(v[0])
            .add(self.h_vec[0].mul(s))
            .add(p_vector_mul(self.h_vec[9:], v[1:]))
        )

    def verify(self, v: list[Point], t: Transcript, proof: CircuitProof) -> bool:
        app_point(b"commitment_cl", proof.c_l, t)
        app_point(b"commitment_cr", proof.c_r, t)
        app_point(b"commitment_co", proof.c_o, t)
        for v_val in v:
            app_point(b"commitment_v", v_val, t)

        rho = get_challenge(b"circuit_rho", t)
        lam = get_challenge(b"circuit_lambda", t)
        beta = get_challenge(b"circuit_beta", t)
        delta = get_challenge(b"circuit_delta", t)
        mu = fn_mul(rho, rho)

        lambda_vec = self._collect_lambda(lam, mu)
        mu_vec = s_vector_mul_on_scalar(e_powers(mu, self.dim_nm), mu)
        c_nL, c_nR, c_nO, c_lL, c_lR, c_lO = self._collect_c(lambda_vec, mu_vec, mu)

        v_ = _IDENT
        for i in range(self.k):
            v_ = v_.add(v[i].mul(self._linear_comb_coef(i, lam, mu)))
        v_ = v_.mul(2)

        app_point(b"commitment_cs", proof.c_s, t)
        tau = get_challenge(b"circuit_tau", t)
        tau_inv = fn_inv(tau)
        tau2 = fn_mul(tau, tau)
        tau3 = fn_mul(tau2, tau)
        delta_inv = fn_inv(delta)

        pn_tau = s_vector_mul_on_scalar(c_nO, fn_mul(tau3, delta_inv))
        pn_tau = s_vector_sub(pn_tau, s_vector_mul_on_scalar(c_nL, tau2))
        pn_tau = s_vector_add(pn_tau, s_vector_mul_on_scalar(c_nR, tau))

        ps_tau = (
            s_weight_vector_mul(pn_tau, pn_tau, mu)
            + fn_mul(fn_mul(s_vector_mul(lambda_vec, self.a_l), tau3), 2)
            - fn_mul(fn_mul(s_vector_mul(mu_vec, self.a_m), tau3), 2)
        ) % N

        pt = self.g.mul(ps_tau).add(p_vector_mul(self.g_vec, pn_tau))
        cr_tau = _cr_tau_vec(tau, tau_inv, tau2, tau3, beta)

        c_l0 = self._collect_cl0(lam, mu)
        cl_tau = s_vector_mul_on_scalar(c_lO, fn_mul(tau3, delta_inv))
        cl_tau = s_vector_sub(cl_tau, s_vector_mul_on_scalar(c_lL, tau2))
        cl_tau = s_vector_add(cl_tau, s_vector_mul_on_scalar(c_lR, tau))
        cl_tau = s_vector_mul_on_scalar(cl_tau, 2)
        cl_tau = s_vector_sub(cl_tau, c_l0)

        c = cr_tau + cl_tau

        commitment = (
            pt.add(proof.c_s.mul(tau_inv))
            .add(proof.c_o.mul(delta).neg())
            .add(proof.c_l.mul(tau))
            .add(proof.c_r.mul(tau2).neg())
            .add(v_.mul(tau3))
        )

        full_h = len(self.h_vec) + len(self.h_vec_)
        while len(c) < full_h:
            c.append(0)

        wnla = WNLA(
            g=self.g,
            g_vec=self.g_vec + self.g_vec_,
            h_vec=self.h_vec + self.h_vec_,
            c=c,
            rho=rho,
            mu=mu,
        )
        return wnla.verify(
            commitment, t, WNLAProof(r=proof.r, x=proof.x, l=proof.l, n=proof.n)
        )

    def prove(
        self, v: list[Point], witness: CircuitWitness, t: Transcript, rng
    ) -> CircuitProof:
        # Blinding lanes with fixed zero patterns (circuit.rs:264-298):
        # ro zeros at 4, 8; rl zeros at 3, 7, 8; rr zeros at 2, 6, 7, 8.
        ro = [rng.scalar() for _ in range(4)] + [0] + [rng.scalar() for _ in range(3)] + [0]
        rl = [rng.scalar() for _ in range(3)] + [0] + [rng.scalar() for _ in range(3)] + [0, 0]
        rr = [rng.scalar() for _ in range(2)] + [0] + [rng.scalar() for _ in range(3)] + [0, 0, 0]

        nl = list(witness.w_l)
        nr = list(witness.w_r)

        def part(typ: PartitionType, size: int) -> list[int]:
            out = []
            for j in range(size):
                i = self.partition(typ, j)
                out.append(witness.w_o[i] if i is not None else 0)
            return out

        no = part(PartitionType.NO, self.dim_nm)
        lo = part(PartitionType.LO, self.dim_nv)
        ll = part(PartitionType.LL, self.dim_nv)
        lr = part(PartitionType.LR, self.dim_nv)

        co = p_vector_mul(self.h_vec, ro + lo).add(p_vector_mul(self.g_vec, no))
        cl = p_vector_mul(self.h_vec, rl + ll).add(p_vector_mul(self.g_vec, nl))
        cr = p_vector_mul(self.h_vec, rr + lr).add(p_vector_mul(self.g_vec, nr))

        app_point(b"commitment_cl", cl, t)
        app_point(b"commitment_cr", cr, t)
        app_point(b"commitment_co", co, t)
        for v_val in v:
            app_point(b"commitment_v", v_val, t)

        rho = get_challenge(b"circuit_rho", t)
        lam = get_challenge(b"circuit_lambda", t)
        beta = get_challenge(b"circuit_beta", t)
        delta = get_challenge(b"circuit_delta", t)
        mu = fn_mul(rho, rho)

        lambda_vec = self._collect_lambda(lam, mu)
        mu_vec = s_vector_mul_on_scalar(e_powers(mu, self.dim_nm), mu)
        c_nL, c_nR, c_nO, c_lL, c_lR, c_lO = self._collect_c(lambda_vec, mu_vec, mu)

        ls = [rng.scalar() for _ in range(self.dim_nv)]
        ns = [rng.scalar() for _ in range(self.dim_nm)]

        v_0 = 0
        for i in range(self.k):
            v_0 = fn_add(
                v_0, fn_mul(witness.v[i][0], self._linear_comb_coef(i, lam, mu))
            )
        v_0 = fn_mul(v_0, 2)

        rv = [0] * 9
        for i in range(self.k):
            rv[0] = fn_add(
                rv[0], fn_mul(witness.s_v[i], self._linear_comb_coef(i, lam, mu))
            )
        rv[0] = fn_mul(rv[0], 2)

        v_1 = [0] * (self.dim_nv - 1)
        for i in range(self.k):
            v_1 = s_vector_add(
                v_1,
                s_vector_mul_on_scalar(
                    witness.v[i][1:], self._linear_comb_coef(i, lam, mu)
                ),
            )
        v_1 = s_vector_mul_on_scalar(v_1, 2)

        c_l0 = self._collect_cl0(lam, mu)

        delta2 = fn_mul(delta, delta)
        delta_inv = fn_inv(delta)
        two = 2

        # f(tau) coefficients at powers [-2, -1, 0, 1, 2, 4, 5, 6]
        # (circuit.rs:399-453). The tau^3 slot must vanish; it carries v.
        f_ = [0] * 8
        f_[0] = s_minus(s_weight_vector_mul(ns, ns, mu))
        f_[1] = fn_add(
            s_vector_mul(c_l0, ls),
            fn_mul(fn_mul(delta, two), s_weight_vector_mul(ns, no, mu)),
        )
        f_[2] = (
            s_minus(fn_mul(s_vector_mul(c_lR, ls), two))
            - fn_mul(s_vector_mul(c_l0, lo), delta)
            - fn_mul(s_weight_vector_mul(ns, s_vector_add(nl, c_nR), mu), two)
            - fn_mul(s_weight_vector_mul(no, no, mu), delta2)
        ) % N
        f_[3] = (
            fn_mul(s_vector_mul(c_lL, ls), two)
            + fn_mul(fn_mul(s_vector_mul(c_lR, lo), delta), two)
            + s_vector_mul(c_l0, ll)
            + fn_mul(s_weight_vector_mul(ns, s_vector_add(nr, c_nL), mu), two)
            + fn_mul(
                fn_mul(s_weight_vector_mul(no, s_vector_add(nl, c_nR), mu), two),
                delta,
            )
        ) % N
        f_[4] = (
            s_weight_vector_mul(c_nR, c_nR, mu)
            - fn_mul(fn_mul(s_vector_mul(c_lO, ls), delta_inv), two)
            - fn_mul(fn_mul(s_vector_mul(c_lL, lo), delta), two)
            - fn_mul(s_vector_mul(c_lR, ll), two)
            - s_vector_mul(c_l0, lr)
            - fn_mul(fn_mul(s_weight_vector_mul(ns, c_nO, mu), delta_inv), two)
            - fn_mul(
                fn_mul(s_weight_vector_mul(no, s_vector_add(nr, c_nL), mu), delta),
                two,
            )
            - s_weight_vector_mul(
                s_vector_add(nl, c_nR), s_vector_add(nl, c_nR), mu
            )
        ) % N
        f_[5] = (
            fn_mul(fn_mul(s_weight_vector_mul(c_nO, c_nR, mu), delta_inv), two)
            + s_weight_vector_mul(c_nL, c_nL, mu)
            - fn_mul(fn_mul(s_vector_mul(c_lO, ll), delta_inv), two)
            - fn_mul(s_vector_mul(c_lL, lr), two)
            - fn_mul(s_vector_mul(c_lR, v_1), two)
            - fn_mul(
                fn_mul(
                    s_weight_vector_mul(s_vector_add(nl, c_nR), c_nO, mu), delta_inv
                ),
                two,
            )
            - s_weight_vector_mul(
                s_vector_add(nr, c_nL), s_vector_add(nr, c_nL), mu
            )
        ) % N
        f_[6] = (
            s_minus(
                fn_mul(fn_mul(s_weight_vector_mul(c_nO, c_nL, mu), delta_inv), two)
            )
            + fn_mul(fn_mul(s_vector_mul(c_nO, lr), delta_inv), two)
            + fn_mul(s_vector_mul(c_lL, v_1), two)
            + fn_mul(
                fn_mul(
                    s_weight_vector_mul(s_vector_add(nr, c_nL), c_nO, mu), delta_inv
                ),
                two,
            )
        ) % N
        f_[7] = s_minus(fn_mul(fn_mul(s_vector_mul(c_lO, v_1), delta_inv), two))

        beta_inv = fn_inv(beta)

        # Blinding combination r_s (circuit.rs:457-467), exact parenthesization.
        rs = [
            fn_add(f_[1], fn_mul(fn_mul(ro[1], delta), beta)),
            fn_mul(f_[0], beta_inv),
            fn_sub(fn_mul(fn_add(fn_mul(ro[0], delta), f_[2]), beta_inv), rl[1]),
            fn_add(
                fn_mul(fn_sub(f_[3], rl[0]), beta_inv),
                fn_add(fn_mul(ro[2], delta), rr[1]),
            ),
            fn_add(
                fn_mul(fn_add(f_[4], rr[0]), beta_inv),
                fn_sub(fn_mul(ro[3], delta), rl[2]),
            ),
            s_minus(fn_mul(rv[0], beta_inv)),
            (fn_mul(f_[5], beta_inv) + fn_mul(ro[5], delta) + rr[3] - rl[4]) % N,
            (fn_mul(f_[6], beta_inv) + rr[4] + fn_mul(ro[6], delta) - rl[5]) % N,
            (fn_mul(f_[7], beta_inv) + fn_mul(ro[7], delta) - rl[6] + rr[5]) % N,
        ]

        cs = p_vector_mul(self.h_vec, rs + ls).add(p_vector_mul(self.g_vec, ns))
        app_point(b"commitment_cs", cs, t)

        tau = get_challenge(b"circuit_tau", t)
        tau_inv = fn_inv(tau)
        tau2 = fn_mul(tau, tau)
        tau3 = fn_mul(tau2, tau)

        l = s_vector_mul_on_scalar(rs + ls, tau_inv)
        l = s_vector_sub(l, s_vector_mul_on_scalar(ro + lo, delta))
        l = s_vector_add(l, s_vector_mul_on_scalar(rl + ll, tau))
        l = s_vector_sub(l, s_vector_mul_on_scalar(rr + lr, tau2))
        l = s_vector_add(l, s_vector_mul_on_scalar(rv + v_1, tau3))

        pn_tau = s_vector_mul_on_scalar(c_nO, fn_mul(tau3, delta_inv))
        pn_tau = s_vector_sub(pn_tau, s_vector_mul_on_scalar(c_nL, tau2))
        pn_tau = s_vector_add(pn_tau, s_vector_mul_on_scalar(c_nR, tau))

        ps_tau = (
            s_weight_vector_mul(pn_tau, pn_tau, mu)
            + fn_mul(fn_mul(s_vector_mul(lambda_vec, self.a_l), tau3), 2)
            - fn_mul(fn_mul(s_vector_mul(mu_vec, self.a_m), tau3), 2)
        ) % N

        n_tau = s_vector_mul_on_scalar(ns, tau_inv)
        n_tau = s_vector_sub(n_tau, s_vector_mul_on_scalar(no, delta))
        n_tau = s_vector_add(n_tau, s_vector_mul_on_scalar(nl, tau))
        n_tau = s_vector_sub(n_tau, s_vector_mul_on_scalar(nr, tau2))
        n = s_vector_add(pn_tau, n_tau)

        cr_tau = _cr_tau_vec(tau, tau_inv, tau2, tau3, beta)
        cl_tau = s_vector_mul_on_scalar(c_lO, fn_mul(tau3, delta_inv))
        cl_tau = s_vector_sub(cl_tau, s_vector_mul_on_scalar(c_lL, tau2))
        cl_tau = s_vector_add(cl_tau, s_vector_mul_on_scalar(c_lR, tau))
        cl_tau = s_vector_mul_on_scalar(cl_tau, 2)
        cl_tau = s_vector_sub(cl_tau, c_l0)
        c = cr_tau + cl_tau

        v_scalar = fn_add(ps_tau, fn_mul(tau3, v_0))
        commitment = (
            self.g.mul(v_scalar)
            .add(p_vector_mul(self.h_vec, l))
            .add(p_vector_mul(self.g_vec, n))
        )

        full_h = len(self.h_vec) + len(self.h_vec_)
        while len(l) < full_h:
            l.append(0)
            c.append(0)
        full_g = len(self.g_vec) + len(self.g_vec_)
        while len(n) < full_g:
            n.append(0)

        wnla = WNLA(
            g=self.g,
            g_vec=self.g_vec + self.g_vec_,
            h_vec=self.h_vec + self.h_vec_,
            c=c,
            rho=rho,
            mu=mu,
        )
        proof_wnla = wnla.prove(commitment, t, l, n)
        return CircuitProof(
            c_l=cl, c_r=cr, c_o=co, c_s=cs,
            r=proof_wnla.r, x=proof_wnla.x, l=proof_wnla.l, n=proof_wnla.n,
        )

    # -- private helpers (circuit.rs:559-653) --------------------------

    def _linear_comb_coef(self, i: int, lam: int, mu: int) -> int:
        coef = 0
        if self.f_l:
            coef = fn_add(coef, s_pow(lam, self.dim_nv * i))
        if self.f_m:
            coef = fn_add(coef, s_pow(mu, self.dim_nv * i + 1))
        return coef

    def _collect_cl0(self, lam: int, mu: int) -> list[int]:
        c_l0 = [0] * (self.dim_nv - 1)
        if self.f_l:
            c_l0 = e_powers(lam, self.dim_nv)[1:]
        if self.f_m:
            c_l0 = s_vector_sub(
                c_l0, s_vector_mul_on_scalar(e_powers(mu, self.dim_nv)[1:], mu)
            )
        return c_l0

    def _collect_lambda(self, lam: int, mu: int) -> list[int]:
        lambda_vec = e_powers(lam, self.dim_nl)
        if self.f_l and self.f_m:
            lambda_vec = s_vector_sub(
                lambda_vec,
                s_vector_add(
                    s_vector_tensor_mul(
                        s_vector_mul_on_scalar(e_powers(lam, self.dim_nv), mu),
                        e_powers(s_pow(mu, self.dim_nv), self.k),
                    ),
                    s_vector_tensor_mul(
                        e_powers(mu, self.dim_nv),
                        e_powers(s_pow(lam, self.dim_nv), self.k),
                    ),
                ),
            )
        return lambda_vec

    def _collect_c(self, lambda_vec, mu_vec, mu):
        M_lnL, M_mnL, M_lnR, M_mnR = self._collect_m_rl()
        (M_lnO, M_mnO, M_llL, M_mlL, M_llR, M_mlR, M_llO, M_mlO) = self._collect_m_o()

        mu_diag_inv = diag_inv(mu, self.dim_nm)

        def lam_minus_mu(Ml, Mm):
            return s_vector_sub(
                s_vector_mul_on_matrix(lambda_vec, Ml),
                s_vector_mul_on_matrix(mu_vec, Mm),
            )

        c_nL = s_vector_mul_on_matrix(lam_minus_mu(M_lnL, M_mnL), mu_diag_inv)
        c_nR = s_vector_mul_on_matrix(lam_minus_mu(M_lnR, M_mnR), mu_diag_inv)
        c_nO = s_vector_mul_on_matrix(lam_minus_mu(M_lnO, M_mnO), mu_diag_inv)
        c_lL = lam_minus_mu(M_llL, M_mlL)
        c_lR = lam_minus_mu(M_llR, M_mlR)
        c_lO = lam_minus_mu(M_llO, M_mlO)
        return c_nL, c_nR, c_nO, c_lL, c_lR, c_lO

    def _collect_m_rl(self):
        nm = self.dim_nm
        M_lnL = [row[:nm] for row in self.W_l]
        M_mnL = [row[:nm] for row in self.W_m]
        M_lnR = [row[nm : 2 * nm] for row in self.W_l]
        M_mnR = [row[nm : 2 * nm] for row in self.W_m]
        return M_lnL, M_mnL, M_lnR, M_mnR

    def _collect_m_o(self):
        nm = self.dim_nm
        W_lO = [row[2 * nm :] for row in self.W_l]
        W_mO = [row[2 * nm :] for row in self.W_m]

        def map_f(isz, jsz, typ, W_x):
            out = []
            for i in range(isz):
                row = []
                for j in range(jsz):
                    j_ = self.partition(typ, j)
                    row.append(W_x[i][j_] if j_ is not None else 0)
                out.append(row)
            return out

        M_lnO = map_f(self.dim_nl, self.dim_nm, PartitionType.NO, W_lO)
        M_llL = map_f(self.dim_nl, self.dim_nv, PartitionType.LL, W_lO)
        M_llR = map_f(self.dim_nl, self.dim_nv, PartitionType.LR, W_lO)
        M_llO = map_f(self.dim_nl, self.dim_nv, PartitionType.LO, W_lO)
        M_mnO = map_f(self.dim_nm, self.dim_nm, PartitionType.NO, W_mO)
        M_mlL = map_f(self.dim_nm, self.dim_nv, PartitionType.LL, W_mO)
        M_mlR = map_f(self.dim_nm, self.dim_nv, PartitionType.LR, W_mO)
        M_mlO = map_f(self.dim_nm, self.dim_nv, PartitionType.LO, W_mO)
        return M_lnO, M_mnO, M_llL, M_mlL, M_llR, M_mlR, M_llO, M_mlO


def _cr_tau_vec(tau, tau_inv, tau2, tau3, beta) -> list[int]:
    """The 9 powers-of-tau * beta entries (circuit.rs:500-510)."""
    return [
        1,
        fn_mul(tau_inv, beta),
        fn_mul(tau, beta),
        fn_mul(tau2, beta),
        fn_mul(tau3, beta),
        fn_mul(fn_mul(tau, tau3), beta),
        fn_mul(fn_mul(tau2, tau3), beta),
        fn_mul(fn_mul(tau3, tau3), beta),
        fn_mul(fn_mul(fn_mul(tau3, tau3), tau), beta),
    ]


from .curve import IDENTITY as _IDENT  # noqa: E402
