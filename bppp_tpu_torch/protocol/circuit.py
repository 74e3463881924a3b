"""Bulletproofs++ arithmetic-circuit protocol, batched.

Counterpart of `bppp_tpu/protocol/circuit.py` (host twin:
oracle/circuit.py). Structural choices, none of which change
transcript bytes:

  * All scalar linear algebra (collect_lambda / collect_c, the f(tau)
    coefficients) runs as batched limb arithmetic over (16, L, *batch)
    tensors; matrix products are lazy limb sums with one fold.
  * W_m / W_l are (16, rows, cols, *batch) limb tensors — they may be
    batch-dependent (the reciprocal layer derives them from challenge e).
  * The diag_inv(mu) right-multiply is a columnwise Hadamard with the
    powers mu^-1, mu^-2, ... (never a materialized n x n matrix).
  * delta / beta / mu inverses come from ONE batched Montgomery-trick
    inversion.
  * Blinding randomness enters as an input tensor (sampled on the host)
    in the exact draw order of the reference, so a replayed RNG
    reproduces the oracle's proofs byte for byte.
  * `verify(fast=True)` builds the WNLA input commitment with one MSM and
    runs the collapsed WNLA verifier; `fast=False` computes P_t and the
    commitment fold as the reference does and runs the mirror verifier.
    Same transcript, same accept set.
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
from .wnla import WNLADevice, WNLAProofBytes, WNLAProofDev

Partition = Callable[[PartitionType, int], Optional[int]]

# Blinding draw counts with fixed zero lanes: ro zeros at {4, 8}; rl zeros
# at {3, 7, 8}; rr zeros at {2, 6, 7, 8}.
RO_DRAWS, RL_DRAWS, RR_DRAWS = 7, 6, 5
_RO_ZEROS, _RL_ZEROS, _RR_ZEROS = {4, 8}, {3, 7, 8}, {2, 6, 7, 8}


def n_blind_draws(dim_nv: int, dim_nm: int) -> int:
    """Total prover randomness: ro + rl + rr + ls(nv) + ns(nm)."""
    return RO_DRAWS + RL_DRAWS + RR_DRAWS + dim_nv + dim_nm


class CircuitProofDev(NamedTuple):
    c_l: PointJ
    c_r: PointJ
    c_o: PointJ
    c_s: PointJ
    wnla: WNLAProofDev


class CircuitProofBytes(NamedTuple):
    c_l: torch.Tensor  # (33, *batch) SEC1 bytes
    c_r: torch.Tensor
    c_o: torch.Tensor
    c_s: torch.Tensor
    wnla: WNLAProofBytes


class CircuitWitnessDev(NamedTuple):
    v: torch.Tensor  # (16, k, nv, *batch)
    s_v: torch.Tensor  # (16, k, *batch)
    w_l: torch.Tensor  # (16, nm, *batch)
    w_r: torch.Tensor  # (16, nm, *batch)
    w_o: torch.Tensor  # (16, no, *batch)


def sm_vec_mat(a, M):
    """Row-vector x matrix over limbs: a (16,R,*b), M (16,R,C,*b) ->
    (16,C,*b). Products are canonical (limbs < 2^16), R <= 2^15 terms sum
    exactly, one fold."""
    prod = f.fn_mul(a[:, :, None], M)  # (16, R, C, *b)
    return f._fold_n(f._carry(prod.sum(dim=1), 18))


def _expand_blind(blind):
    """blind: (16, >=18, *b) draw stream -> (ro, rl, rr, rest) where
    ro/rl/rr are (16, 9, *b) with the reference's fixed zero lanes."""
    zero = torch.zeros_like(blind[:, 0])

    def lanes(start, zeros):
        out = []
        idx = start
        for j in range(9):
            if j in zeros:
                out.append(zero)
            else:
                out.append(blind[:, idx])
                idx += 1
        return torch.stack(out, dim=1), idx

    ro, idx = lanes(0, _RO_ZEROS)
    rl, idx2 = lanes(idx, _RL_ZEROS)
    rr, idx3 = lanes(idx2, _RR_ZEROS)
    return ro, rl, rr, blind[:, idx3:]


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

    def _all_points(self) -> PointJ:
        """The 'full' table layout [g | h_vec + h_vec_ | g_vec + g_vec_]."""
        return pv.pv_concat(
            [pv.single(self.g), self.h_vec, self.h_vec_, self.g_vec, self.g_vec_]
        )

    def commit(self, v, s) -> PointJ:
        """C = v[0]*g + s*h_vec[0] + <h_vec[9:], v[1:]>.
        v: (16, nv, *b), s: (16, *b). With window tables present the
        kernel walks only the nv + 1 live table positions."""
        nv1 = v.shape[1] - 1
        scal = sv.sv_concat([v[:, :1], s[:, None], v[:, 1:]])
        if self.tables is not None and pv.pv_len(self.h_vec) >= 9 + nv1:
            from ..ops import fixed_base as fb

            positions = (0, 1) + tuple(range(10, 10 + nv1))
            return fb.msm_fixed_positions(
                self.tables.get("full"), self._all_points(), positions, scal
            )
        pts = pv.pv_concat(
            [
                pv.single(self.g),
                PointJ(*(a[:, :1] for a in self.h_vec)),
                PointJ(*(a[:, 9:] for a in self.h_vec)),
            ]
        )
        return pv.msm(pts, scal)

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
        fast=False: P_t, the committed-v combination and the commitment
        fold are separate MSMs and the mirror WNLA verifier runs.
        pre: optional (four, xr) pre-decompressed proof points — four =
        [C_S, C_O, C_L, C_R] coords (16, 4, *b), xr = the WNLA X|R points
        (16, 2K, *b) — so a caller can batch ALL decompressions (its own
        plus this layer's) into one sqrt ladder."""
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

        # v_ = 2 * sum_i coef_i V_i (deferred into the MSM on the fast path)
        coefs = torch.stack(
            [self._linear_comb_coef(i, lam, mu) for i in range(self.k)], dim=1
        )
        v_coefs = f.fn_mul(coefs, two[:, None])
        if not fast:
            v_ = pv.msm(v, v_coefs)

        t.append_message(b"commitment_cs", proof.c_s)
        tau = t.challenge_scalar(b"circuit_tau")
        tau_inv = f.fn_inv(tau)
        tau2 = f.fn_mul(tau, tau)
        tau3 = f.fn_mul(tau2, tau)

        pn_tau, ps_tau = self._pn_ps(
            c_nL, c_nR, c_nO, lambda_vec, mu_vec, mu, tau, tau2, tau3, delta_inv,
            two, mu_pows=mu_pows,
        )
        if not fast:
            # P_t = ps*g + <g_vec, pn>
            p_t = pv.msm(
                pv.pv_concat([pv.single(self.g), self.g_vec]),
                sv.sv_concat([ps_tau[:, None], sv.sv_pad(pn_tau, pv.pv_len(self.g_vec))]),
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
        if fast:
            # ONE MSM: P_t's terms (ps*g + <g_vec, pn>), the C_* folds, and
            # the committed-v combination together. The fixed part
            # [g | g_vec] rides the precomputed window tables.
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
        else:
            fold_pts = pv.pv_concat([pv.single(p) for p in (cs, co, cl, cr, v_)])
            all_scs = sv.sv_concat([fold_scs, tau3[:, None]])
            commitment = dc.pt_add(p_t, pv.msm(fold_pts, all_scs))

        # WNLA fast-path contract: the padded generator totals
        # (|h_vec|+|h_vec_|, |g_vec|+|g_vec_|) should be divisible by
        # 2^num_rounds — true for the u64 dims (32, 16) and any
        # power-of-two circuit. Other sizes still verify, through the
        # mirror verifier (see WNLADevice.verify_fast).
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
        if fast:
            return wnla.verify_fast(commitment, t, proof.wnla, xr=xr)
        return wnla.verify(commitment, t, proof.wnla, xr=xr)

    def prove(
        self, v: PointJ, v_bytes, witness: CircuitWitnessDev, t: Transcript, blind
    ) -> CircuitProofDev:
        """v: the k commitment points (unused beyond their bytes); v_bytes
        (33, k, *b) their SEC1 bytes; blind: (16, n_blind_draws(nv, nm), *b)
        — the blinding stream in reference draw order."""
        batch = self.batch
        dev = self.device
        two = sv.s_const(2, batch, device=dev)
        ro, rl, rr, rest = _expand_blind(blind)
        ls = rest[:, : self.dim_nv]
        ns = rest[:, self.dim_nv : self.dim_nv + self.dim_nm]

        nl_, nr_ = witness.w_l, witness.w_r
        no = self._part_vec(witness.w_o, PartitionType.NO, self.dim_nm)
        lo = self._part_vec(witness.w_o, PartitionType.LO, self.dim_nv)
        ll = self._part_vec(witness.w_o, PartitionType.LL, self.dim_nv)
        lr = self._part_vec(witness.w_o, PartitionType.LR, self.dim_nv)

        # Every prover commitment is an MSM over the FIXED generator set
        # [g | h_vec+h_vec_ | g_vec+g_vec_] (the 'full' window-table
        # layout), and the kernel walks ONLY each commitment's live
        # positions (msm_fixed_positions): the blind lanes minus their
        # fixed zeros, and the partition's live slots.
        from ..ops import fixed_base as fb

        hv, gv = self.h_vec, self.g_vec
        full_h = pv.pv_len(hv) + pv.pv_len(self.h_vec_)
        full_g = pv.pv_len(gv) + pv.pv_len(self.g_vec_)
        all_pts = self._all_points()
        tab = self.tables.get("full") if self.tables else None
        g_base = 1 + full_h

        def part_slots(typ, size):
            return tuple(j for j in range(size) if self.partition(typ, j) is not None)

        def sub_commit(r_, r_zeros, l_, l_slots, n_, n_slots):
            """<h[0:9], r_> + <h[9+l_slots], l_> + <g[n_slots], n_> with
            the statically-zero lanes dropped from the walk."""
            r_live = tuple(j for j in range(9) if j not in r_zeros)
            positions = (
                tuple(1 + j for j in r_live)
                + tuple(10 + j for j in l_slots)
                + tuple(g_base + j for j in n_slots)
            )
            scal = torch.cat(
                [r_[:, list(r_live)], l_[:, list(l_slots)], n_[:, list(n_slots)]], dim=1
            )
            return fb.msm_fixed_positions(tab, all_pts, positions, scal)

        all_nm = tuple(range(self.dim_nm))
        c_o = sub_commit(
            ro, _RO_ZEROS,
            lo, part_slots(PartitionType.LO, self.dim_nv),
            no, part_slots(PartitionType.NO, self.dim_nm),
        )
        c_l = sub_commit(
            rl, _RL_ZEROS,
            ll, part_slots(PartitionType.LL, self.dim_nv),
            nl_, all_nm,
        )
        c_r = sub_commit(
            rr, _RR_ZEROS,
            lr, part_slots(PartitionType.LR, self.dim_nv),
            nr_, all_nm,
        )

        three = pv.pv_concat([pv.single(c_l), pv.single(c_r), pv.single(c_o)])
        byts = dc.compress(three)
        t.append_message(b"commitment_cl", byts[:, 0])
        t.append_message(b"commitment_cr", byts[:, 1])
        t.append_message(b"commitment_co", byts[:, 2])
        for i in range(self.k):
            t.append_message(b"commitment_v", v_bytes[:, i])

        rho = t.challenge_scalar(b"circuit_rho")
        lam = t.challenge_scalar(b"circuit_lambda")
        beta = t.challenge_scalar(b"circuit_beta")
        delta = t.challenge_scalar(b"circuit_delta")
        mu = f.fn_mul(rho, rho)

        inv3 = sv.fn_inv_vec(torch.stack([mu, delta, beta], dim=1))
        mu_inv, delta_inv, beta_inv = inv3[:, 0], inv3[:, 1], inv3[:, 2]

        lambda_vec = self._collect_lambda(lam, mu)
        # mu_pows = [mu, mu^2, ...]: shared by mu_vec, every weighted inner
        # product below, and pn/ps — computed once.
        mu_pows = sv.sv_powers(mu, max(self.dim_nm, self.dim_nv), start_at_one=False)
        mu_vec = mu_pows[:, : self.dim_nm]
        c_nL, c_nR, c_nO, c_lL, c_lR, c_lO = self._collect_c(
            lambda_vec, mu_vec, mu_inv
        )

        coefs = torch.stack(
            [self._linear_comb_coef(i, lam, mu) for i in range(self.k)], dim=1
        )  # (16, k, *b)

        # v_0 = 2 sum coef_i v[i][0]; rv[0] = 2 sum coef_i s_v[i];
        # v_1 = 2 sum coef_i v[i][1:]
        v0_terms = f.fn_mul(witness.v[:, :, 0], coefs)
        v_0 = f.fn_mul(sv.sv_sum(v0_terms), two)
        rv0 = f.fn_mul(sv.sv_sum(f.fn_mul(witness.s_v, coefs)), two)
        zero = torch.zeros_like(rv0)
        rv = torch.stack([rv0] + [zero] * 8, dim=1)  # (16, 9, *b)
        v_1 = f.fn_mul(witness.v[:, :, 1:], coefs[:, :, None])  # (16, k, nv-1, *b)
        v_1 = f._fold_n(f._carry(v_1.sum(dim=1), 18))
        v_1 = sv.sv_scale(v_1, two)

        c_l0 = self._collect_cl0(lam, mu)
        delta2 = f.fn_mul(delta, delta)

        W = lambda a, b, _mu: sv.sv_weight_inner(a, b, _mu, pw=mu_pows)
        I = sv.sv_inner
        M = f.fn_mul
        A = f.fn_add
        S = f.fn_sub
        NEG = f.fn_neg

        nl_cnr = sv.sv_add(nl_, c_nR)
        nr_cnl = sv.sv_add(nr_, c_nL)

        # f(tau) coefficients at powers [-2, -1, 0, 1, 2, 4, 5, 6]
        f0 = NEG(W(ns, ns, mu))
        f1 = A(I(c_l0, ls), M(M(delta, two), W(ns, no, mu)))
        f2 = S(
            S(
                S(NEG(M(I(c_lR, ls), two)), M(I(c_l0, lo), delta)),
                M(W(ns, nl_cnr, mu), two),
            ),
            M(W(no, no, mu), delta2),
        )
        f3 = A(
            A(
                A(M(I(c_lL, ls), two), M(M(I(c_lR, lo), delta), two)),
                A(I(c_l0, ll), M(W(ns, nr_cnl, mu), two)),
            ),
            M(M(W(no, nl_cnr, mu), two), delta),
        )
        f4 = S(
            S(
                S(
                    S(W(c_nR, c_nR, mu), M(M(I(c_lO, ls), delta_inv), two)),
                    S(
                        A(M(M(I(c_lL, lo), delta), two), M(I(c_lR, ll), two)),
                        NEG(I(c_l0, lr)),
                    ),
                ),
                A(
                    M(M(W(ns, c_nO, mu), delta_inv), two),
                    M(M(W(no, nr_cnl, mu), delta), two),
                ),
            ),
            W(nl_cnr, nl_cnr, mu),
        )
        f5 = S(
            S(
                S(
                    A(
                        M(M(W(c_nO, c_nR, mu), delta_inv), two),
                        W(c_nL, c_nL, mu),
                    ),
                    A(
                        M(M(I(c_lO, ll), delta_inv), two),
                        A(M(I(c_lL, lr), two), M(I(c_lR, v_1), two)),
                    ),
                ),
                M(M(W(nl_cnr, c_nO, mu), delta_inv), two),
            ),
            W(nr_cnl, nr_cnl, mu),
        )
        f6 = A(
            A(
                NEG(M(M(W(c_nO, c_nL, mu), delta_inv), two)),
                A(
                    M(M(I(c_nO, lr), delta_inv), two),
                    M(I(c_lL, v_1), two),
                ),
            ),
            M(M(W(nr_cnl, c_nO, mu), delta_inv), two),
        )
        f7 = NEG(M(M(I(c_lO, v_1), delta_inv), two))

        # r_s blinding combination
        ro_l = [ro[:, j] for j in range(9)]
        rl_l = [rl[:, j] for j in range(9)]
        rr_l = [rr[:, j] for j in range(9)]
        rs = torch.stack(
            [
                A(f1, M(M(ro_l[1], delta), beta)),
                M(f0, beta_inv),
                S(M(A(M(ro_l[0], delta), f2), beta_inv), rl_l[1]),
                A(M(S(f3, rl_l[0]), beta_inv), A(M(ro_l[2], delta), rr_l[1])),
                A(M(A(f4, rr_l[0]), beta_inv), S(M(ro_l[3], delta), rl_l[2])),
                NEG(M(rv0, beta_inv)),
                A(A(M(f5, beta_inv), M(ro_l[5], delta)), S(rr_l[3], rl_l[4])),
                A(A(M(f6, beta_inv), rr_l[4]), S(M(ro_l[6], delta), rl_l[5])),
                A(A(M(f7, beta_inv), M(ro_l[7], delta)), S(rr_l[5], rl_l[6])),
            ],
            dim=1,
        )  # (16, 9, *b)

        # C_S: every blind lane of rs is live; skip only the h_vec_ pad
        # positions and the unused g position 0
        cs_scalars = sv.sv_concat([rs, ls])
        nh_live = 9 + self.dim_nv
        cs_pos = tuple(range(1, 1 + nh_live)) + tuple(
            g_base + j for j in range(self.dim_nm)
        )
        c_s = fb.msm_fixed_positions(
            tab, all_pts, cs_pos, sv.sv_concat([cs_scalars, ns])
        )
        t.append_message(b"commitment_cs", dc.compress(c_s))

        tau = t.challenge_scalar(b"circuit_tau")
        # one Montgomery-trick ladder covers tau^-1 AND the WNLA entry
        # inverse rho^-1; mu^-1 is already known from the ladder above
        inv2 = sv.fn_inv_vec(torch.stack([tau, rho], dim=1))
        tau_inv, rho_inv_w = inv2[:, 0], inv2[:, 1]
        tau2 = f.fn_mul(tau, tau)
        tau3 = f.fn_mul(tau2, tau)

        ro_lo = sv.sv_concat([ro, lo])
        rl_ll = sv.sv_concat([rl, ll])
        rr_lr = sv.sv_concat([rr, lr])
        rv_v1 = sv.sv_concat([rv, v_1])

        # l(tau) = tau^-1 (rs||ls) - delta (ro||lo) + tau (rl||ll)
        #        - tau^2 (rr||lr) + tau^3 (rv||v1)
        l_vec = sv.sv_scale(cs_scalars, tau_inv)
        l_vec = sv.sv_sub(l_vec, sv.sv_scale(ro_lo, delta))
        l_vec = sv.sv_add(l_vec, sv.sv_scale(rl_ll, tau))
        l_vec = sv.sv_sub(l_vec, sv.sv_scale(rr_lr, tau2))
        l_vec = sv.sv_add(l_vec, sv.sv_scale(rv_v1, tau3))

        pn_tau, ps_tau = self._pn_ps(
            c_nL, c_nR, c_nO, lambda_vec, mu_vec, mu, tau, tau2, tau3, delta_inv,
            two, mu_pows=mu_pows,
        )

        n_tau = sv.sv_scale(ns, tau_inv)
        n_tau = sv.sv_sub(n_tau, sv.sv_scale(no, delta))
        n_tau = sv.sv_add(n_tau, sv.sv_scale(nl_, tau))
        n_tau = sv.sv_sub(n_tau, sv.sv_scale(nr_, tau2))
        n_vec = sv.sv_add(pn_tau, n_tau)

        c_vec = self._c_vec(
            c_lL, c_lR, c_lO, lam, mu, tau, tau_inv, tau2, tau3, beta, delta_inv, two
        )

        # WNLA input commitment: l_vec spans h 1..nh_live and n_vec all of
        # g — only the h_vec_ pad positions drop out of the walk
        v_scalar = A(ps_tau, M(tau3, v_0))
        com_pos = (
            (0,)
            + tuple(range(1, 1 + l_vec.shape[1]))
            + tuple(g_base + j for j in range(n_vec.shape[1]))
        )
        commitment = fb.msm_fixed_positions(
            tab, all_pts, com_pos, sv.sv_concat([v_scalar[:, None], l_vec, n_vec])
        )

        wnla = WNLADevice(
            g=self.g,
            g_vec=pv.pv_concat([gv, self.g_vec_]),
            h_vec=pv.pv_concat([hv, self.h_vec_]),
            c_vec=sv.sv_pad(c_vec, full_h),
            rho=rho,
            mu=mu,
            tables=tab,
        )
        wnla_proof = wnla.prove(
            commitment, t, sv.sv_pad(l_vec, full_h), sv.sv_pad(n_vec, full_g),
            inv=(rho_inv_w, mu_inv),
            zero_tail=(full_h - l_vec.shape[1], full_g - n_vec.shape[1]),
        )
        return CircuitProofDev(c_l=c_l, c_r=c_r, c_o=c_o, c_s=c_s, wnla=wnla_proof)

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

    def _part_vec(self, w_o, typ: PartitionType, size: int):
        """Gather w_o entries through the static partition map; None -> 0."""
        zero = torch.zeros((16,) + self.batch, dtype=f.DTYPE, device=self.device)
        cols = []
        for j in range(size):
            i = self.partition(typ, j)
            cols.append(w_o[:, i] if i is not None else zero)
        return torch.stack(cols, dim=1)

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
