"""Weight-norm linear argument, batched over proofs.

Counterpart of `bppp_tpu/protocol/wnla.py` (host twin: oracle/wnla.py).
Structural choices, none of which alter a transcript byte:

  * The recursion depth is a static function of (|l|, |n|) and is unrolled
    in Python; everything carries a trailing batch shape, so one call
    proves or verifies B independent instances of shared sizes.
  * The mirror prover computes X and R of a round by ONE stacked MSM (the
    point and scalar lists are padded to a common length and stacked on an
    extra lane axis), so the ladder runs once per round.
  * rho^-1 / mu^-1 per round come from a single pair of inversions at
    entry: the fold sets (rho', mu') = (mu, mu^2), so inverses chain by
    squaring.
  * `verify_fast` / `_prove_fast` never fold the generators: per-round
    coefficient vectors over the ORIGINAL generators and fixed-base MSMs
    take the place of the per-round scalar multiplications of the mirror
    `verify` / `prove`. Sizes not divisible by 2^rounds give way to the
    mirror versions.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..ops import curve as c
from ..ops import field as f
from ..ops.curve import PointJ
from ..transcript.device import Transcript
from . import points as pv
from . import vectors as sv


class WNLAProofDev(NamedTuple):
    """Proof as the prover leaves it: Jacobian points stacked
    innermost-first on axis 1."""

    r: PointJ  # (16, K, *batch)
    x: PointJ  # (16, K, *batch)
    l: torch.Tensor  # (16, Ll, *batch) F_n limbs
    n: torch.Tensor  # (16, Ln, *batch)


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


def _msm_stack(groups):
    """groups: list of (points: PointJ, scalars) pairs -> PointJ
    (16, M, *batch) computing each group's MSM with ONE shared ladder."""
    L = max(max(pv.pv_len(p), s.shape[1]) for p, s in groups)
    pts, scs = [], []
    for p, s in groups:
        p = pv.pv_pad(p, L)
        pts.append(PointJ(*(a[:, :, None] for a in p)))
        scs.append(sv.sv_pad(s, L)[:, :, None])
    points = PointJ(*(torch.cat(cs, dim=2) for cs in zip(*pts)))
    scalars = torch.cat(scs, dim=2)  # (16, L, M, *batch)
    return c.msm(points, scalars)  # reduces axis 1 -> (16, M, *batch)


def _stack_points(ps, batch, device) -> PointJ:
    if not ps:
        return c.identity((0,) + tuple(batch), device=device)
    return PointJ(*(torch.stack(cs, dim=1) for cs in zip(*ps)))


def _assert_zero_tail(a, z: int, what: str) -> None:
    """Debug check of the `zero_tail` contract: the last z entries of `a`
    are zero. On the card the check is a device-side assertion on the
    current stream; nothing synchronises."""
    if not (__debug__ and z):
        return
    ok = (a[:, a.shape[1] - z :] == 0).all()
    msg = f"zero_tail: the last {z} entries of {what} must be zero"
    if ok.is_cuda:
        torch._assert_async(ok, msg)
    else:
        assert bool(ok), msg


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

    @property
    def device(self):
        return self.rho.device

    # -- commitment ---------------------------------------------------------

    def commit_value(self, l, n):
        """v = <c, l> + |n|^2_mu."""
        return f.fn_add(sv.sv_inner(self.c, l), sv.sv_weight_inner(n, n, self.mu))

    def commit(self, l, n) -> PointJ:
        v = self.commit_value(l, n)
        pts = pv.pv_concat([pv.single(self.g), self.h_vec, self.g_vec])
        scs = sv.sv_concat(
            [
                v[:, None],
                sv.sv_pad(l, pv.pv_len(self.h_vec)),
                sv.sv_pad(n, pv.pv_len(self.g_vec)),
            ]
        )
        return pv.msm(pts, scs)

    # -- prove ----------------------------------------------------------------

    def prove(
        self, commitment: PointJ, t: Transcript, l, n, inv=None, zero_tail=(0, 0)
    ) -> WNLAProofDev:
        """inv: optional precomputed (rho^-1, mu^-1) — a caller that already
        ran a batched inversion passes them in.
        zero_tail: static (zh, zg) — the caller guarantees that the LAST zh
        entries of l and zg entries of n are zero (the circuit layer pads
        l(tau) to |h_vec|); the fast prover then skips the table rows whose
        X/R coefficients are provably zero."""
        lh, lg = l.shape[1], n.shape[1]
        assert lh == pv.pv_len(self.h_vec) and lg == pv.pv_len(self.g_vec)
        K = num_rounds(lh, lg)
        if K > 0 and lh % (1 << K) == 0 and lg % (1 << K) == 0:
            return self._prove_fast(commitment, t, l, n, K, inv=inv, zero_tail=zero_tail)
        if K > 0:
            # transcript-identical, so the proof is the same — only slower
            warnings.warn(
                f"WNLA prove: |h|={lh}, |g|={lg} not divisible by 2^K={1 << K}; "
                "using the mirror prover (per-round scalar multiplications of "
                "the folded generators). Pad the instance to power-of-two sizes "
                "for the fast path.",
                stacklevel=2,
            )
        return self._prove_mirror(commitment, t, l, n, K, inv=inv)

    def _prove_mirror(self, commitment, t, l, n, K: int, inv=None) -> WNLAProofDev:
        """The prover as the reference runs it: generators folded per round."""
        if inv is None:
            inv2 = sv.fn_inv_vec(torch.stack([self.rho, self.mu], dim=1))
            inv = inv2[:, 0], inv2[:, 1]
        rho_inv, mu_inv = inv

        cur = self
        xs, rs = [], []
        for _ in range(K):
            commitment, l, n, x_pt, r_pt, cur = _prove_round(
                cur, commitment, t, l, n, rho_inv
            )
            xs.append(x_pt)
            rs.append(r_pt)
            # fold law (rho', mu') = (mu, mu^2) => inverses chain by squaring
            rho_inv = mu_inv
            mu_inv = f.fn_mul(mu_inv, mu_inv)

        xs.reverse()  # innermost-first
        rs.reverse()
        return WNLAProofDev(
            r=_stack_points(rs, self.batch, self.device),
            x=_stack_points(xs, self.batch, self.device),
            l=l, n=n,
        )

    def _prove_fast(
        self, commitment, t, l, n, K: int, inv=None, zero_tail=(0, 0)
    ) -> WNLAProofDev:
        """Prover twin of `verify_fast` (transcript-identical to the mirror
        prover): every per-round X/R commitment is expressed over the
        ORIGINAL generators via kron-expanded coefficient vectors — one
        fixed-base MSM per commitment instead of scalar multiplications of
        the folded generators — and the commitment chain uses the
        verifier's fold identity C' = C + y X + (y^2-1) R, which for an
        honest prover is the same group element the reference recomputes
        from scratch. The generators are never folded; only c / l / n
        (scalars) fold per round.

        Derivation: with h_k[q] = sum_{m<2^k} w_k[m] h[(q<<k)|m] (w_k the
        per-round kron of [1, y_k]) the X-round terms <h0_k, l1> +
        <h1_k, l0> become <h, w_k (x) interleave(l1, l0)> over the original
        h; the g-side uses wg_k (kron of [rho_k, y_k]) and
        interleave(rho_k n1, rho_k^-1 n0); R (only odd-half generators)
        uses interleave(0, l1) / interleave(0, n1). Requires |h|, |g|
        divisible by 2^K."""
        from ..ops import fixed_base as fb

        batch = self.batch
        dev = self.device
        lh, lg = pv.pv_len(self.h_vec), pv.pv_len(self.g_vec)
        one = sv.s_const(1, batch, device=dev)
        two = sv.s_const(2, batch, device=dev)
        all_pts = pv.pv_concat([pv.single(self.g), self.h_vec, self.g_vec])

        if inv is None:
            inv2 = sv.fn_inv_vec(torch.stack([self.rho, self.mu], dim=1))
            inv = inv2[:, 0], inv2[:, 1]
        rho_inv, mu_inv = inv
        rho_k, mu_k = self.rho, self.mu
        cvec = self.c
        w_h = one[:, None]
        w_g = one[:, None]
        # static trailing-zero counts of l / n (zero_tail contract): the
        # fold l' = l0 + y l1 keeps a pair of zeros zero, so z' = z // 2.
        # X's original-row coefficient for row block m is
        # (l1[t] if m = 2t else l0[t]) * w — zero blocks are the TRAILING
        # 2 * (z // 2) interleave entries; R touches only l1[t] = l_k[2t+1],
        # zero for t >= (|l| - z) // 2. Both trims are static position-range
        # cuts, so the kernel walks fewer table rows.
        zh, zg = zero_tail
        _assert_zero_tail(l, zh, "l")
        _assert_zero_tail(n, zg, "n")

        xs, rs = [], []
        for k in range(K):
            c0, c1 = sv.sv_split(cvec)
            l0, l1 = sv.sv_split(l)
            n0, n1 = sv.sv_split(n)
            mu2 = f.fn_mul(mu_k, mu_k)
            pw2 = sv.sv_powers(mu2, max(n0.shape[1], 1), start_at_one=False)
            vx = f.fn_add(
                f.fn_mul(
                    sv.sv_weight_inner(n0, n1, mu2, pw=pw2),
                    f.fn_mul(rho_inv, two),
                ),
                f.fn_add(sv.sv_inner(c0, l1), sv.sv_inner(c1, l0)),
            )
            vr = f.fn_add(
                sv.sv_weight_inner(n1, n1, mu2, pw=pw2), sv.sv_inner(c1, l1)
            )

            K_ = 1 << k
            # live pair counts after dropping provably-zero trailing
            # coefficient blocks (no-ops when zero_tail is (0, 0))
            xh_p = l0.shape[1] - zh // 2
            xg_p = n0.shape[1] - zg // 2
            xh = sv.sv_tensor(w_h, sv.sv_interleave(l1[:, :xh_p], l0[:, :xh_p]))
            xg = sv.sv_tensor(
                w_g,
                sv.sv_interleave(
                    sv.sv_scale(n1[:, :xg_p], rho_k),
                    sv.sv_scale(n0[:, :xg_p], rho_inv),
                ),
            )
            # X covers the contiguous live-row prefixes of h and g; R's
            # kron coefficients are additionally zero at every even
            # inner-interleave position (R only touches the odd halves),
            # so its walk covers about half the rows.
            x_pos = (
                (0,)
                + tuple(range(1, 1 + 2 * xh_p * K_))
                + tuple(range(1 + lh, 1 + lh + 2 * xg_p * K_))
            )
            x_scal = sv.sv_concat([vx[:, None], xh, xg])
            if len(x_pos) == 1 + lh + lg:
                x_pt = fb.msm_fixed_total(self.tables, all_pts, x_scal)
            else:
                x_pt = fb.msm_fixed_positions(self.tables, all_pts, x_pos, x_scal)
            # sv_tensor(a, b)[:, j*La + i] = a_i * b_j (b is the OUTER axis),
            # so R's live positions are p = (2t+1) * 2^k + i, ordered
            # (t outer, i inner) — sv_tensor(w, odd_half)'s layout — for the
            # live t prefix only. l1[t] = l_k[2t+1] is zero for
            # 2t+1 >= |l| - zh.
            rh_p = (l1.shape[1] * 2 - zh) // 2  # live l1 entries
            rg_p = (n1.shape[1] * 2 - zg) // 2
            r_pos = (
                (0,)
                + tuple(1 + (2 * j + 1) * K_ + i for j in range(rh_p) for i in range(K_))
                + tuple(1 + lh + (2 * j + 1) * K_ + i for j in range(rg_p) for i in range(K_))
            )
            rh = sv.sv_tensor(w_h, l1[:, :rh_p])
            rg = sv.sv_tensor(w_g, n1[:, :rg_p])
            r_pt = fb.msm_fixed_positions(
                self.tables, all_pts, r_pos, sv.sv_concat([vr[:, None], rh, rg])
            )
            xs.append(x_pt)
            rs.append(r_pt)

            three = pv.pv_concat([pv.single(commitment), pv.single(x_pt), pv.single(r_pt)])
            byts = c.compress(three)
            t.append_message(b"wnla_com", byts[:, 0])
            t.append_message(b"wnla_x", byts[:, 1])
            t.append_message(b"wnla_r", byts[:, 2])
            t.append_u64(b"l.sz", l.shape[1])
            t.append_u64(b"n.sz", n.shape[1])
            y = t.challenge_scalar(b"wnla_challenge")

            l = sv.sv_add(l0, sv.sv_scale(l1, y))
            n = sv.sv_add(sv.sv_scale(n0, rho_inv), sv.sv_scale(n1, y))
            cvec = sv.sv_add(c0, sv.sv_scale(c1, y))
            w_h = sv.sv_tensor(w_h, torch.stack([one, y], dim=1))
            w_g = sv.sv_tensor(w_g, torch.stack([rho_k, y], dim=1))
            if k < K - 1:
                y2m1 = f.fn_sub(f.fn_mul(y, y), one)
                folded = pv.msm(
                    pv.pv_concat([pv.single(x_pt), pv.single(r_pt)]),
                    torch.stack([y, y2m1], dim=1),
                )
                commitment = c.pt_add(commitment, folded)
            rho_k, mu_k = mu_k, mu2
            rho_inv = mu_inv
            mu_inv = f.fn_mul(mu_inv, mu_inv)
            zh //= 2  # a zero PAIR folds to a zero entry
            zg //= 2

        xs.reverse()
        rs.reverse()
        return WNLAProofDev(
            r=_stack_points(rs, batch, dev), x=_stack_points(xs, batch, dev), l=l, n=n
        )

    # -- verify ---------------------------------------------------------------

    def verify(self, commitment: PointJ, t: Transcript, proof: WNLAProofBytes, xr=None):
        """-> (*batch,) bool mask. Mirror verifier: folds the generators
        per round exactly as the reference does (one scalar multiplication
        over [g0 | g1 | h1] per round). xr: optional pre-decompressed X|R
        points, coords (16, 2K, *batch) — callers batch ALL proof-point
        decompressions into one sqrt ladder."""
        lh, lg = pv.pv_len(self.h_vec), pv.pv_len(self.g_vec)
        K = num_rounds(lh, lg)
        assert proof.r.shape[1] == K and proof.x.shape[1] == K

        both = (
            c.decompress(torch.cat([proof.x, proof.r], dim=1)) if xr is None else xr
        )
        xs = PointJ(*(a[:, :K] for a in both))  # coords (16, K, *batch)
        rs = PointJ(*(a[:, K:] for a in both))
        one = sv.s_const(1, self.batch, device=self.device)

        cur = self
        for k in range(K):
            idx = K - 1 - k  # the verifier consumes from the END
            x_pt = PointJ(*(a[:, idx] for a in xs))
            r_pt = PointJ(*(a[:, idx] for a in rs))
            t.append_message(b"wnla_com", c.compress(commitment))
            t.append_message(b"wnla_x", proof.x[:, idx])
            t.append_message(b"wnla_r", proof.r[:, idx])
            t.append_u64(b"l.sz", pv.pv_len(cur.h_vec))
            t.append_u64(b"n.sz", pv.pv_len(cur.g_vec))
            y = t.challenge_scalar(b"wnla_challenge")

            # C' = C + y X + (y^2 - 1) R
            y2m1 = f.fn_sub(f.fn_mul(y, y), one)
            folded = pv.msm(
                pv.pv_concat([pv.single(x_pt), pv.single(r_pt)]),
                torch.stack([y, y2m1], dim=1),
            )
            commitment = c.pt_add(commitment, folded)
            cur = cur._fold_public(y)

        return c.pt_eq(commitment, cur.commit(proof.l, proof.n))

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
        if K == 0:
            return self.verify(commitment, t, proof, xr=xr)
        M = 1 << K
        if lh % M != 0 or lg % M != 0:
            # the transcript-identical mirror verifier accepts exactly the
            # same proofs: correctness is kept, only speed differs
            warnings.warn(
                f"WNLA verify_fast: |h|={lh}, |g|={lg} not divisible by 2^K={M}; "
                "giving way to the mirror verifier (per-round scalar "
                "multiplications of the folded generators). Pad the instance to "
                "power-of-two sizes.",
                stacklevel=2,
            )
            return self.verify(commitment, t, proof, xr=xr)
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

    # -- internals ------------------------------------------------------------

    def _fold_public(self, y) -> "WNLADevice":
        """h' = h0 + y h1, g' = rho g0 + y g1, c' = c0 + y c1,
        (rho', mu') = (mu, mu^2). One shared ladder for the three point
        scalings."""
        c0, c1 = sv.sv_split(self.c)
        g0, g1 = pv.pv_split(self.g_vec)
        h0, h1 = pv.pv_split(self.h_vec)

        Lg0, Lg1, Lh1 = pv.pv_len(g0), pv.pv_len(g1), pv.pv_len(h1)
        pts = pv.pv_concat([g0, g1, h1])
        scs = sv.sv_concat(
            [
                self.rho[:, None].expand((16, Lg0) + self.batch),
                y[:, None].expand((16, Lg1) + self.batch),
                y[:, None].expand((16, Lh1) + self.batch),
            ]
        )
        scaled = c.pt_scalar_mul(pts, scs)
        sg0 = PointJ(*(a[:, :Lg0] for a in scaled))
        sg1 = PointJ(*(a[:, Lg0 : Lg0 + Lg1] for a in scaled))
        sh1 = PointJ(*(a[:, Lg0 + Lg1 :] for a in scaled))

        return WNLADevice(
            g=self.g,
            g_vec=pv.pv_add(sg0, sg1),
            h_vec=pv.pv_add(h0, sh1),
            c_vec=sv.sv_add(c0, sv.sv_scale(c1, y)),
            rho=self.mu,
            mu=f.fn_mul(self.mu, self.mu),
        )


def _prove_round(cur: WNLADevice, commitment, t, l, n, rho_inv):
    """One folding round of the mirror prover. Returns the next state."""
    c0, c1 = sv.sv_split(cur.c)
    l0, l1 = sv.sv_split(l)
    n0, n1 = sv.sv_split(n)
    g0, g1 = pv.pv_split(cur.g_vec)
    h0, h1 = pv.pv_split(cur.h_vec)
    mu2 = f.fn_mul(cur.mu, cur.mu)

    two = sv.s_const(2, cur.batch, device=cur.device)
    pw2 = sv.sv_powers(mu2, max(n0.shape[1], 1), start_at_one=False)
    vx = f.fn_add(
        f.fn_mul(sv.sv_weight_inner(n0, n1, mu2, pw=pw2), f.fn_mul(rho_inv, two)),
        f.fn_add(sv.sv_inner(c0, l1), sv.sv_inner(c1, l0)),
    )
    vr = f.fn_add(sv.sv_weight_inner(n1, n1, mu2, pw=pw2), sv.sv_inner(c1, l1))

    # X = vx*g + <h0,l1> + <h1,l0> + <g0, rho n1> + <g1, rho^-1 n0>
    # R = vr*g + <h1,l1> + <g1,n1>      — one stacked ladder for both.
    # Each term pads points (identity) and scalars (zero) to a common
    # length, for the odd and empty halves.
    def term(p, s):
        L = max(pv.pv_len(p), s.shape[1])
        return pv.pv_pad(p, L), sv.sv_pad(s, L)

    def build(terms):
        pts, scs = zip(*(term(p, s) for p, s in terms))
        return pv.pv_concat(pts), sv.sv_concat(scs)

    x_groups = build(
        [
            (pv.single(cur.g), vx[:, None]),
            (h0, l1),
            (h1, l0),
            (g0, sv.sv_scale(n1, cur.rho)),
            (g1, sv.sv_scale(n0, rho_inv)),
        ]
    )
    r_groups = build([(pv.single(cur.g), vr[:, None]), (h1, l1), (g1, n1)])
    xr = _msm_stack([x_groups, r_groups])
    x_pt = PointJ(*(a[:, 0] for a in xr))
    r_pt = PointJ(*(a[:, 1] for a in xr))

    # compress all three absorbed points with one shared inversion
    three = pv.pv_concat([pv.single(commitment), pv.single(x_pt), pv.single(r_pt)])
    byts = c.compress(three)  # (33, 3, *batch)
    t.append_message(b"wnla_com", byts[:, 0])
    t.append_message(b"wnla_x", byts[:, 1])
    t.append_message(b"wnla_r", byts[:, 2])
    t.append_u64(b"l.sz", l.shape[1])
    t.append_u64(b"n.sz", n.shape[1])
    y = t.challenge_scalar(b"wnla_challenge")

    nxt = cur._fold_public(y)
    l_ = sv.sv_add(l0, sv.sv_scale(l1, y))
    n_ = sv.sv_add(sv.sv_scale(n0, rho_inv), sv.sv_scale(n1, y))

    # the prover recomputes the folded commitment from scratch
    com_ = nxt.commit(l_, n_)
    return com_, l_, n_, x_pt, r_pt, nxt
