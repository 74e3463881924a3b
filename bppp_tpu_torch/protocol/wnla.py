"""Weight-norm linear argument, verifier side, batched over proofs.

Counterpart of the verifier half of `bppp_tpu/protocol/wnla.py` (host
twin: oracle/wnla.py). Ported: the collapsed ("fast") verifier. The
recursion depth is a static function of (|l|, |n|) and is unrolled in
Python; everything carries a trailing batch shape, so one call verifies B
independent instances of shared sizes.

The mirror verifier (per-round generator folds) and the prover need the
ladder kernel and belong to later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import curve as c
from ..ops import field as f
from ..ops.curve import PointJ
from ..transcript.device import Transcript
from . import points as pv
from . import vectors as sv

MIRROR_LATER = "mirror verifier: later slice (needs the ladder kernel)"


class WNLAProofBytes(NamedTuple):
    """Wire-form proof for the verifier: SEC1-compressed X/R bytes are
    absorbed directly (the transcript needs the exact bytes) and
    decompressed once for the arithmetic. Points are stacked
    innermost-first on axis 1."""

    r: torch.Tensor  # (33, K, *batch) bytes
    x: torch.Tensor  # (33, K, *batch)
    l: torch.Tensor  # (16, Ll, *batch) limbs
    n: torch.Tensor  # (16, Ln, *batch)


def num_rounds(lh: int, lg: int) -> int:
    """Static recursion depth: fold while |l| + |n| >= 6."""
    k = 0
    while lh + lg >= 6:
        lh = lh - lh // 2  # even half keeps ceil(L/2)
        lg = lg - lg // 2
        k += 1
    return k


class WNLADevice:
    """One WNLA instance family: fixed sizes, batched data.

    g: PointJ (16, *batch); g_vec/h_vec: PointJ (16, L, *batch);
    c_vec: (16, Lh, *batch) limbs; rho/mu: (16, *batch) limbs; tables:
    optional fixed-base window tables for [g | h_vec | g_vec]
    (ops/fixed_base.py), used by verify_fast's final MSM."""

    def __init__(
        self, g: PointJ, g_vec: PointJ, h_vec: PointJ, c_vec, rho, mu,
        tables=None,
    ):
        self.g = g
        self.g_vec = g_vec
        self.h_vec = h_vec
        self.c = sv.sv_pad(c_vec, pv.pv_len(h_vec))
        self.rho = rho
        self.mu = mu
        self.batch = tuple(g.x.shape[1:])
        self.tables = tables

    def verify(self, commitment: PointJ, t: Transcript, proof: WNLAProofBytes, xr=None):
        raise NotImplementedError(MIRROR_LATER)

    def verify_fast(
        self, commitment: PointJ, t: Transcript, proof: WNLAProofBytes, xr=None
    ):
        """Collapsed verifier -> (*batch,) bool mask. Transcript-identical
        to the mirror verifier, but the per-round generator folds (the
        expensive point work) are replaced by scalar coefficient vectors
        over the ORIGINAL generators and ONE MSM at the end.

        After K folds, h_K[j] = sum_m (prod_k y_k^{bit_k(m)}) h_0[(j<<K)|m]
        and g_K picks factor rho_k for 0-bits; the folded commitment
        chain C' = C + y X + (y^2-1) R must still materialize per round
        because its bytes are absorbed (wnla_com), but the last round's
        X/R fold moves into the final MSM. Requires |h|, |g| divisible by
        2^K (all power-of-two instances, the u64 dims among them).
        xr: optional pre-decompressed X|R points, coords (16, 2K, *batch)."""
        lh, lg = pv.pv_len(self.h_vec), pv.pv_len(self.g_vec)
        K = num_rounds(lh, lg)
        M = 1 << K
        if K == 0 or lh % M != 0 or lg % M != 0:
            # these sizes give way to the mirror verifier
            raise NotImplementedError(MIRROR_LATER)
        assert proof.r.shape[1] == K and proof.x.shape[1] == K
        assert proof.l.shape[1] == lh // M and proof.n.shape[1] == lg // M

        both = (
            c.decompress(torch.cat([proof.x, proof.r], dim=1)) if xr is None else xr
        )
        xs = PointJ(*(a[:, :K] for a in both))
        rs = PointJ(*(a[:, K:] for a in both))
        batch = self.batch
        one = sv.s_const(1, batch, device=self.rho.device)

        ys, rho_factors = [], []
        rho_k, mu_k = self.rho, self.mu
        C = commitment
        for k in range(K):
            idx = K - 1 - k  # the verifier consumes from the END
            t.append_message(b"wnla_com", c.compress(C))
            t.append_message(b"wnla_x", proof.x[:, idx])
            t.append_message(b"wnla_r", proof.r[:, idx])
            t.append_u64(b"l.sz", lh >> k)
            t.append_u64(b"n.sz", lg >> k)
            y = t.challenge_scalar(b"wnla_challenge")
            ys.append(y)
            rho_factors.append(rho_k)
            rho_k, mu_k = mu_k, f.fn_mul(mu_k, mu_k)
            if k < K - 1:
                x_pt = PointJ(*(a[:, idx] for a in xs))
                r_pt = PointJ(*(a[:, idx] for a in rs))
                y2m1 = f.fn_sub(f.fn_mul(y, y), one)
                folded = pv.msm(
                    pv.pv_concat([pv.single(x_pt), pv.single(r_pt)]),
                    torch.stack([y, y2m1], dim=1),
                )
                C = c.pt_add(C, folded)

        # coefficient vectors over original generators (kron over rounds)
        w_h = one[:, None]
        w_g = one[:, None]
        for k in range(K):
            w_h = sv.sv_tensor(w_h, torch.stack([one, ys[k]], dim=1))
            w_g = sv.sv_tensor(w_g, torch.stack([rho_factors[k], ys[k]], dim=1))
        a_coef = sv.sv_tensor(w_h, proof.l)  # (16, lh, *b)
        b_coef = sv.sv_tensor(w_g, proof.n)  # (16, lg, *b)

        # folded public c vector: c_K[j] = sum_m w_h[m] * c0[(j<<K)|m]
        c0 = self.c.reshape((16, lh // M, M) + batch)
        ck_terms = f.fn_mul(c0, w_h[:, None])
        c_K = f._fold_n(f._carry(ck_terms.sum(dim=2), 18))

        v_final = f.fn_add(
            sv.sv_inner(c_K, proof.l),
            sv.sv_weight_inner(proof.n, proof.n, mu_k),  # mu_k = mu^(2^K)
        )

        # final check: C_{K-1} + y X_0 + (y^2-1) R_0 == v g + <h,a> + <g,b>
        # -> fold the last X/R into the MSM with negated coefficients.
        last_y = ys[-1]
        neg_y = f.fn_neg(last_y)
        neg_y2m1 = f.fn_neg(f.fn_sub(f.fn_mul(last_y, last_y), one))
        x0 = PointJ(*(a[:, 0] for a in xs))
        r0 = PointJ(*(a[:, 0] for a in rs))
        from ..ops import fixed_base as fb

        fixed_pts = pv.pv_concat([pv.single(self.g), self.h_vec, self.g_vec])
        fixed_scs = sv.sv_concat([v_final[:, None], a_coef, b_coef])
        dyn_pts = pv.pv_concat([pv.single(x0), pv.single(r0)])
        dyn_scs = sv.sv_concat([neg_y[:, None], neg_y2m1[:, None]])
        rhs = fb.msm_mixed(self.tables, fixed_pts, fixed_scs, dyn_pts, dyn_scs)
        return c.pt_eq(C, rhs)
