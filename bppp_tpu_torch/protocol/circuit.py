"""Bulletproofs++ arithmetic-circuit protocol, verifier side, batched.

Counterpart of the verifier half of `bppp_tpu/protocol/circuit.py` (host
twin: oracle/circuit.py). Structural choices, none of which change
transcript bytes:

  * All scalar linear algebra (collect_lambda / collect_c, the f(tau)
    coefficients) runs as batched limb arithmetic over (16, L, *batch)
    tensors; matrix products are lazy limb sums with one fold.
  * W_m / W_l are (16, rows, cols, *batch) limb tensors — they may be
    batch-dependent (the reciprocal layer derives them from challenge e).
  * The diag_inv(mu) right-multiply is a columnwise Hadamard with the
    powers mu^-1, mu^-2, ... (never a materialized n x n matrix).
  * mu and delta inverses come from ONE batched Montgomery-trick
    inversion.

Ported: `verify` with `fast=True` (one MSM builds the WNLA input
commitment, then the collapsed WNLA verifier). `fast=False` and the
prover belong to later slices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..oracle.circuit import PartitionType
from ..ops import curve as dc
from ..ops import field as f
from ..ops.curve import PointJ
from ..transcript.device import Transcript
from . import points as pv
from . import vectors as sv
from .wnla import MIRROR_LATER, WNLADevice, WNLAProofBytes

Partition = Callable[[PartitionType, int], Optional[int]]


class CircuitProofBytes(NamedTuple):
    c_l: torch.Tensor  # (33, *batch) SEC1 bytes
    c_r: torch.Tensor
    c_o: torch.Tensor
    c_s: torch.Tensor
    wnla: WNLAProofBytes


def sm_vec_mat(a, M):
    """Row-vector x matrix over limbs: a (16,R,*b), M (16,R,C,*b) ->
    (16,C,*b). Products are canonical (limbs < 2^16), R <= 2^15 terms sum
    exactly, one fold."""
    prod = f.fn_mul(a[:, :, None], M)  # (16, R, C, *b)
    return f._fold_n(f._carry(prod.sum(dim=1), 18))


class ArithmeticCircuitDevice:
    """Batched circuit instance. Static: dims, flags, partition.
    Batched limb data: generators, W_m/W_l, a_m/a_l."""

    def __init__(
        self,
        *,
        dim_nm: int,
        dim_no: int,
        k: int,
        dim_nl: int,
        dim_nv: int,
        dim_nw: int,
        g: PointJ,
        g_vec: PointJ,
        h_vec: PointJ,
        W_m,
        W_l,
        a_m,
        a_l,
        f_l: bool,
        f_m: bool,
        g_vec_: PointJ,
        h_vec_: PointJ,
        partition: Partition,
        tables=None,
        collect_c=None,
    ):
        self.dim_nm, self.dim_no, self.k = dim_nm, dim_no, k
        self.dim_nl, self.dim_nv, self.dim_nw = dim_nl, dim_nv, dim_nw
        self.g, self.g_vec, self.h_vec = g, g_vec, h_vec
        self.g_vec_, self.h_vec_ = g_vec_, h_vec_
        self.W_m, self.W_l = W_m, W_l
        self.a_m, self.a_l = a_m, a_l
        self.f_l, self.f_m = f_l, f_m
        self.partition = partition
        self.batch = tuple(g.x.shape[1:])
        self.device = g.x.device
        # fixed-base window tables (ops/fixed_base.py): dict with 'gv'
        # ([g | g_vec]) for this layer's fast MSM and 'full'
        # ([g | h_vec+h_vec_ | g_vec+g_vec_]) for the WNLA final MSM.
        self.tables = tables
        # optional structured override for _collect_c: circuits with
        # sparse/structured W (e.g. the reciprocal range proof) supply
        # closed forms instead of the dense row-vec x matrix products.
        self.collect_c_override = collect_c

    def verify(
        self,
        v: PointJ,
        v_bytes,
        t: Transcript,
        proof: CircuitProofBytes,
        fast: bool = False,
        pre=None,
    ):
        """v: k commitment points, coords (16, k, *b); v_bytes (33, k, *b)
        are the exact SEC1 bytes to absorb. -> (*b,) bool.

        fast=True: one MSM builds the WNLA input commitment and the
        collapsed WNLA verifier runs (transcript-identical to the mirror).
        pre: optional (four, xr) pre-decompressed proof points — four =
        [C_S, C_O, C_L, C_R] coords (16, 4, *b), xr = the WNLA X|R points
        (16, 2K, *b) — so a caller can batch ALL decompressions (its own
        plus this layer's) into one sqrt ladder."""
        if not fast:
            raise NotImplementedError(MIRROR_LATER)
        t.append_message(b"commitment_cl", proof.c_l)
        t.append_message(b"commitment_cr", proof.c_r)
        t.append_message(b"commitment_co", proof.c_o)
        for i in range(self.k):
            t.append_message(b"commitment_v", v_bytes[:, i])

        rho = t.challenge_scalar(b"circuit_rho")
        lam = t.challenge_scalar(b"circuit_lambda")
        beta = t.challenge_scalar(b"circuit_beta")
        delta = t.challenge_scalar(b"circuit_delta")
        mu = f.fn_mul(rho, rho)
        two = sv.s_const(2, self.batch, device=self.device)

        inv2 = sv.fn_inv_vec(torch.stack([mu, delta], dim=1))
        mu_inv, delta_inv = inv2[:, 0], inv2[:, 1]

        lambda_vec = self._collect_lambda(lam, mu)
        mu_pows = sv.sv_powers(mu, max(self.dim_nm, self.dim_nv), start_at_one=False)
        mu_vec = mu_pows[:, : self.dim_nm]
        c_nL, c_nR, c_nO, c_lL, c_lR, c_lO = self._collect_c(
            lambda_vec, mu_vec, mu_inv
        )

        # v_ = 2 * sum_i coef_i V_i, deferred into the MSM below
        coefs = torch.stack(
            [self._linear_comb_coef(i, lam, mu) for i in range(self.k)], dim=1
        )
        v_coefs = f.fn_mul(coefs, two[:, None])

        t.append_message(b"commitment_cs", proof.c_s)
        tau = t.challenge_scalar(b"circuit_tau")
        tau_inv = f.fn_inv(tau)
        tau2 = f.fn_mul(tau, tau)
        tau3 = f.fn_mul(tau2, tau)

        pn_tau, ps_tau = self._pn_ps(
            c_nL, c_nR, c_nO, lambda_vec, mu_vec, mu, tau, tau2, tau3, delta_inv,
            two, mu_pows=mu_pows,
        )
        c_vec = self._c_vec(
            c_lL, c_lR, c_lO, lam, mu, tau, tau_inv, tau2, tau3, beta, delta_inv, two
        )

        # commitment = P_t + tau^-1 C_S - delta C_O + tau C_L - tau^2 C_R + tau^3 v_
        # (one stacked decompression: a single sqrt ladder for all of this
        # layer's four points AND the WNLA X/R points)
        if pre is None:
            stacked = dc.decompress(
                torch.cat(
                    [
                        torch.stack(
                            [proof.c_s, proof.c_o, proof.c_l, proof.c_r], dim=1
                        ),
                        proof.wnla.x,
                        proof.wnla.r,
                    ],
                    dim=1,
                )
            )
            four = PointJ(*(a[:, :4] for a in stacked))
            xr = PointJ(*(a[:, 4:] for a in stacked))
        else:
            four, xr = pre
        cs, co, cl, cr = (PointJ(*(a[:, i] for a in four)) for i in range(4))
        fold_scs = torch.stack(
            [tau_inv, f.fn_neg(delta), tau, f.fn_neg(tau2)], dim=1
        )
        # ONE MSM: P_t's terms (ps*g + <g_vec, pn>), the C_* folds, and the
        # committed-v combination together. The fixed part [g | g_vec]
        # rides the precomputed window tables.
        from ..ops import fixed_base as fb

        fixed_pts = pv.pv_concat([pv.single(self.g), self.g_vec])
        fixed_scs = sv.sv_concat(
            [ps_tau[:, None], sv.sv_pad(pn_tau, pv.pv_len(self.g_vec))]
        )
        dyn_pts = pv.pv_concat([pv.single(p) for p in (cs, co, cl, cr)] + [v])
        dyn_scs = sv.sv_concat([fold_scs, f.fn_mul(v_coefs, tau3[:, None])])
        commitment = fb.msm_mixed(
            self.tables.get("gv") if self.tables else None,
            fixed_pts,
            fixed_scs,
            dyn_pts,
            dyn_scs,
        )

        # WNLA fast-path contract: the padded generator totals
        # (|h_vec|+|h_vec_|, |g_vec|+|g_vec_|) are divisible by
        # 2^num_rounds — true for the u64 dims (32, 16) and any
        # power-of-two circuit.
        wnla = WNLADevice(
            g=self.g,
            g_vec=pv.pv_concat([self.g_vec, self.g_vec_]),
            h_vec=pv.pv_concat([self.h_vec, self.h_vec_]),
            c_vec=sv.sv_pad(
                c_vec, pv.pv_len(self.h_vec) + pv.pv_len(self.h_vec_)
            ),
            rho=rho,
            mu=mu,
            tables=self.tables.get("full") if self.tables else None,
        )
        return wnla.verify_fast(commitment, t, proof.wnla, xr=xr)

    # -- shared subexpressions -------------------------------------------

    def _pn_ps(
        self,
        c_nL, c_nR, c_nO, lambda_vec, mu_vec, mu, tau, tau2, tau3, delta_inv, two,
        mu_pows=None,
    ):
        """pn(tau) = tau^3 d^-1 c_nO - tau^2 c_nL + tau c_nR;
        ps(tau) = |pn|^2_mu + 2 tau^3 (<lambda, a_l> - <mu_vec, a_m>)."""
        pn = sv.sv_scale(c_nO, f.fn_mul(tau3, delta_inv))
        pn = sv.sv_sub(pn, sv.sv_scale(c_nL, tau2))
        pn = sv.sv_add(pn, sv.sv_scale(c_nR, tau))
        ps = f.fn_add(
            sv.sv_weight_inner(pn, pn, mu, pw=mu_pows),
            f.fn_mul(
                f.fn_mul(
                    f.fn_sub(
                        sv.sv_inner(lambda_vec, self.a_l),
                        sv.sv_inner(mu_vec, self.a_m),
                    ),
                    tau3,
                ),
                two,
            ),
        )
        return pn, ps

    def _c_vec(
        self, c_lL, c_lR, c_lO, lam, mu, tau, tau_inv, tau2, tau3, beta, delta_inv, two
    ):
        """c = cr_tau(9) || 2(tau^3 d^-1 c_lO - tau^2 c_lL + tau c_lR) - c_l0."""
        one = sv.s_const(1, self.batch, device=self.device)
        t4 = f.fn_mul(tau, tau3)
        t5 = f.fn_mul(tau2, tau3)
        t6 = f.fn_mul(tau3, tau3)
        t7 = f.fn_mul(t6, tau)
        pows = torch.stack([tau_inv, tau, tau2, tau3, t4, t5, t6, t7], dim=1)
        cr = torch.cat([one[:, None], f.fn_mul(pows, beta[:, None])], dim=1)
        cl = sv.sv_scale(c_lO, f.fn_mul(tau3, delta_inv))
        cl = sv.sv_sub(cl, sv.sv_scale(c_lL, tau2))
        cl = sv.sv_add(cl, sv.sv_scale(c_lR, tau))
        cl = sv.sv_scale(cl, two)
        cl = sv.sv_sub(cl, self._collect_cl0(lam, mu))
        return sv.sv_concat([cr, cl])

    # -- private helpers ---------------------------------------------------

    def _linear_comb_coef(self, i: int, lam, mu):
        coef = torch.zeros((16,) + self.batch, dtype=f.DTYPE, device=self.device)
        if self.f_l:
            coef = f.fn_add(coef, _pow_static(lam, self.dim_nv * i))
        if self.f_m:
            coef = f.fn_add(coef, _pow_static(mu, self.dim_nv * i + 1))
        return coef

    def _collect_cl0(self, lam, mu):
        c_l0 = sv.sv_zeros(self.dim_nv - 1, self.batch, device=self.device)
        if self.f_l:
            c_l0 = sv.sv_powers(lam, self.dim_nv)[:, 1:]
        if self.f_m:
            c_l0 = sv.sv_sub(
                c_l0, sv.sv_scale(sv.sv_powers(mu, self.dim_nv)[:, 1:], mu)
            )
        return c_l0

    def _collect_lambda(self, lam, mu):
        lambda_vec = sv.sv_powers(lam, self.dim_nl)
        if self.f_l and self.f_m:
            lam_nv = _pow_static(lam, self.dim_nv)
            mu_nv = _pow_static(mu, self.dim_nv)
            lambda_vec = sv.sv_sub(
                lambda_vec,
                sv.sv_add(
                    sv.sv_tensor(
                        sv.sv_scale(sv.sv_powers(lam, self.dim_nv), mu),
                        sv.sv_powers(mu_nv, self.k),
                    ),
                    sv.sv_tensor(
                        sv.sv_powers(mu, self.dim_nv),
                        sv.sv_powers(lam_nv, self.k),
                    ),
                ),
            )
        return lambda_vec

    def _collect_c(self, lambda_vec, mu_vec, mu_inv):
        if self.collect_c_override is not None:
            return self.collect_c_override(lambda_vec, mu_vec, mu_inv)
        nm = self.dim_nm
        W_l, W_m = self.W_l, self.W_m
        M_lnL, M_mnL = W_l[:, :, :nm], W_m[:, :, :nm]
        M_lnR, M_mnR = W_l[:, :, nm : 2 * nm], W_m[:, :, nm : 2 * nm]
        W_lO, W_mO = W_l[:, :, 2 * nm :], W_m[:, :, 2 * nm :]

        def map_cols(W, typ, size):
            zero = W.new_zeros((16, W.shape[1]) + self.batch)
            cols = []
            for j in range(size):
                j_ = self.partition(typ, j)
                cols.append(W[:, :, j_] if j_ is not None else zero)
            return torch.stack(cols, dim=2)

        M_lnO = map_cols(W_lO, PartitionType.NO, nm)
        M_llL = map_cols(W_lO, PartitionType.LL, self.dim_nv)
        M_llR = map_cols(W_lO, PartitionType.LR, self.dim_nv)
        M_llO = map_cols(W_lO, PartitionType.LO, self.dim_nv)
        M_mnO = map_cols(W_mO, PartitionType.NO, nm)
        M_mlL = map_cols(W_mO, PartitionType.LL, self.dim_nv)
        M_mlR = map_cols(W_mO, PartitionType.LR, self.dim_nv)
        M_mlO = map_cols(W_mO, PartitionType.LO, self.dim_nv)

        mu_inv_pows = sv.sv_powers(mu_inv, nm, start_at_one=False)

        def lam_minus_mu(Ml, Mm):
            return sv.sv_sub(sm_vec_mat(lambda_vec, Ml), sm_vec_mat(mu_vec, Mm))

        c_nL = sv.sv_hadamard(lam_minus_mu(M_lnL, M_mnL), mu_inv_pows)
        c_nR = sv.sv_hadamard(lam_minus_mu(M_lnR, M_mnR), mu_inv_pows)
        c_nO = sv.sv_hadamard(lam_minus_mu(M_lnO, M_mnO), mu_inv_pows)
        c_lL = lam_minus_mu(M_llL, M_mlL)
        c_lR = lam_minus_mu(M_llR, M_mlR)
        c_lO = lam_minus_mu(M_llO, M_mlO)
        return c_nL, c_nR, c_nO, c_lL, c_lR, c_lO


def _pow_static(x, e: int):
    """x^e for a static small exponent (square-and-multiply)."""
    if e == 0:
        one = torch.zeros_like(x)
        one[0] = 1
        return one
    bits = bin(e)[2:]
    acc = x
    for bit in bits[1:]:
        acc = f.fn_mul(acc, acc)
        if bit == "1":
            acc = f.fn_mul(acc, x)
    return acc
