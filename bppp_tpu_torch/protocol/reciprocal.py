"""Reciprocal range proof, batched.

Counterpart of `bppp_tpu/protocol/reciprocal.py` (host twin:
oracle/reciprocal.py).

  * The dim_nd digit reciprocals r_i = (d_i + e)^-1 and the dim_np pole
    constants (e + j)^-1 are inverted in ONE Montgomery-trick batch.
  * make_circuit builds W_m / W_l as batched limb tensors from challenge
    e by stacking static blocks with the two data-dependent blocks (the
    -e diagonal and the pole row), and supplies closed forms for the
    circuit layer's collect_c.
  * verify decompresses all 14 proof points in one stacked call and folds
    every wire-format check into the accept mask; nothing raises on
    malformed bytes.
  * prove takes the circuit commitment as V + R (one point add): it is
    the same group element as the circuit layer's own commitment of
    [x || r] under s + r_blind, and compression normalises the
    representative, so the absorbed bytes are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..oracle.circuit import PartitionType
from ..oracle.field import N as N_INT
from ..ops import curve as dc
from ..ops import field as f
from ..ops.curve import PointJ
from ..transcript.device import Transcript
from . import points as pv
from . import vectors as sv
from .circuit import (
    ArithmeticCircuitDevice,
    CircuitProofBytes,
    CircuitProofDev,
    CircuitWitnessDev,
    n_blind_draws,
)


class ReciprocalProofDev(NamedTuple):
    circuit: CircuitProofDev
    r: PointJ  # poles commitment


class ReciprocalProofBytes(NamedTuple):
    circuit: CircuitProofBytes
    r: torch.Tensor  # (33, *batch)


class ReciprocalWitnessDev(NamedTuple):
    x: torch.Tensor  # (16, *batch) value limbs
    s: torch.Tensor  # (16, *batch) blinding
    m: torch.Tensor  # (16, np, *batch) multiplicities
    digits: torch.Tensor  # (16, nd, *batch)


def reciprocal_blind_draws(dim_nd: int) -> int:
    """r_blind + the circuit's draws."""
    return 1 + n_blind_draws(dim_nd + 1, dim_nd)


class ReciprocalRangeProofDevice:
    def __init__(
        self,
        *,
        dim_nd: int,
        dim_np: int,
        g: PointJ,
        g_vec: PointJ,
        h_vec: PointJ,
        g_vec_: PointJ,
        h_vec_: PointJ,
        tables=None,
    ):
        self.dim_nd, self.dim_np = dim_nd, dim_np
        self.g, self.g_vec, self.h_vec = g, g_vec, h_vec
        self.g_vec_, self.h_vec_ = g_vec_, h_vec_
        self.tables = tables  # fixed-base window tables (circuit layer)
        self.batch = tuple(g.x.shape[1:])
        self.device = g.x.device

    def _fixed_commit(self, parts) -> PointJ:
        """MSM over a static-position SUBSET of the fixed-generator table
        layout [g | h_vec | h_vec_ | g_vec | g_vec_]: parts =
        [(table_pos, (16, k, *b) scalars)], static positions. The kernel
        walks ONLY the live generators (commit_value touches 2 of 49,
        commit_poles 17)."""
        from ..ops import fixed_base as fb

        all_pts = pv.pv_concat(
            [pv.single(self.g), self.h_vec, self.h_vec_, self.g_vec, self.g_vec_]
        )
        positions, segs = [], []
        for pos, scs in sorted(parts, key=lambda p: p[0]):
            positions.extend(range(pos, pos + scs.shape[1]))
            segs.append(scs)
        tab = self.tables.get("full") if self.tables else None
        return fb.msm_fixed_positions(tab, all_pts, tuple(positions), sv.sv_concat(segs))

    def commit_value(self, x, s) -> PointJ:
        """x*g + s*h_vec[0]."""
        if self.tables is not None:
            return self._fixed_commit([(0, x[:, None]), (1, s[:, None])])
        pts = pv.pv_concat([pv.single(self.g), PointJ(*(a[:, :1] for a in self.h_vec))])
        return pv.msm(pts, torch.stack([x, s], dim=1))

    def commit_poles(self, r, s) -> PointJ:
        """s*h_vec[0] + <h_vec[9:], r>."""
        if self.tables is not None:
            # h_vec[0] is table position 1; h_vec[9:] starts at position 10
            return self._fixed_commit([(1, s[:, None]), (10, r)])
        pts = pv.pv_concat(
            [
                PointJ(*(a[:, :1] for a in self.h_vec)),
                PointJ(*(a[:, 9:] for a in self.h_vec)),
            ]
        )
        return pv.msm(pts, sv.sv_concat([s[:, None], r]))

    def verify(
        self,
        commitment_bytes,
        t: Transcript,
        proof: ReciprocalProofBytes,
        fast: bool = False,
    ):
        """commitment_bytes: (33, *batch) SEC1 bytes of V. -> (*b,) bool."""
        t.append_message(b"reciprocal_commitment", commitment_bytes)
        e = t.challenge_scalar(b"reciprocal_challenge")
        circuit = self.make_circuit(e)
        # ALL 14 proof-point decompressions (V, R, the circuit's C_S/C_O/
        # C_L/C_R, and the WNLA X/R) in ONE stacked sqrt ladder.
        cp = proof.circuit
        allb = torch.cat(
            [
                torch.stack(
                    [commitment_bytes, proof.r, cp.c_s, cp.c_o, cp.c_l, cp.c_r],
                    dim=1,
                ),
                cp.wnla.x,
                cp.wnla.r,
            ],
            dim=1,
        )
        pts, pt_ok = dc.decompress_checked(allb)
        # malformed-wire hardening: off-curve / non-canonical point bytes
        # and out-of-range scalars must yield False, never an undefined
        # accept bit and never an exception
        wire_ok = pt_ok.all(dim=0)
        for sc in (cp.wnla.l, cp.wnla.n):
            # limbs_lt_const assumes normalized 16-bit limbs, but the wire
            # type is wider — a non-normalized encoding (e.g. limb[0] +=
            # 2^16, limb[1] -= 1) is the same integer yet a different
            # byte string, so it is rejected to keep the encoding
            # non-malleable
            wire_ok = wire_ok & ((sc >> 16) == 0).all(dim=0).all(dim=0)
            wire_ok = wire_ok & f.limbs_lt_const(sc, f.N_INT).all(dim=0)
        v_pt = PointJ(*(a[:, 0] for a in pts))
        r_pt = PointJ(*(a[:, 1] for a in pts))
        four = PointJ(*(a[:, 2:6] for a in pts))
        xr = PointJ(*(a[:, 6:] for a in pts))
        cc = dc.pt_add(v_pt, r_pt)  # circuit commitment = V + R
        cc_bytes = dc.compress(cc)
        ok = circuit.verify(
            pv.single(cc),
            cc_bytes[:, None],
            t,
            proof.circuit,
            fast=fast,
            pre=(four, xr),
        )
        return ok & wire_ok

    def prove(
        self,
        commitment: PointJ,
        witness: ReciprocalWitnessDev,
        t: Transcript,
        blind,
    ) -> ReciprocalProofDev:
        """blind: (16, reciprocal_blind_draws(nd), *b) blinding stream
        (draw order: r_blind first, then the circuit's draws)."""
        t.append_message(b"reciprocal_commitment", dc.compress(commitment))
        e = t.challenge_scalar(b"reciprocal_challenge")

        # r_i = (d_i + e)^-1, batched with the pole constants (e+j)^-1
        # that make_circuit needs — ONE inversion ladder for all nd + np.
        d_plus_e = f.fn_add(witness.digits, e[:, None])
        poles_in = _e_plus_j(e, self.dim_np)
        inv_all = sv.fn_inv_vec(sv.sv_concat([d_plus_e, poles_in]))
        r = inv_all[:, : self.dim_nd]
        pole_inv = inv_all[:, self.dim_nd :]

        r_blind = blind[:, 0]
        r_com = self.commit_poles(r, r_blind)

        circuit = self.make_circuit(e, pole_inv=pole_inv)
        v_vec = sv.sv_concat([witness.x[:, None], r])
        s_v = f.fn_add(witness.s, r_blind)
        # circuit.commit([x || r], s + r_blind) == commit_value(x, s) +
        # commit_poles(r, r_blind): one point add instead of an
        # 18-position table walk
        cc = dc.pt_add(commitment, r_com)
        cc_bytes = dc.compress(cc)

        cw = CircuitWitnessDev(
            v=v_vec[:, None],  # (16, k=1, nv, *b)
            s_v=s_v[:, None],
            w_l=witness.digits,
            w_r=r,
            w_o=witness.m,
        )
        cp = circuit.prove(pv.single(cc), cc_bytes[:, None], cw, t, blind[:, 1:])
        return ReciprocalProofDev(circuit=cp, r=r_com)

    def make_circuit(self, e, pole_inv=None) -> ArithmeticCircuitDevice:
        """Deterministic challenge -> circuit.

        W_m (nm x nw): -e on the diagonal of the R block.
        W_l (nl x nw): row 0 = -base^i over the L block; rows 1..nm have
        (1 - eye) over the R block and -(e+j)^-1 over the O block."""
        nm, np_ = self.dim_nd, self.dim_np
        nv = nm + 1
        nl = nv
        nw = 2 * nm + np_
        batch = self.batch
        dev = self.device
        nb = len(batch)

        if pole_inv is None:
            pole_inv = sv.fn_inv_vec(_e_plus_j(e, np_))
        neg_pole = f.fn_neg(pole_inv)  # (16, np, *b)
        neg_e = f.fn_neg(e)

        # W_m: (16, nm, nw, *b) = -e * diag mask in the R block
        diag_mask = np.zeros((nm, nw), dtype=np.int64)
        for i in range(nm):
            diag_mask[i, nm + i] = 1
        W_m = neg_e[:, None, None] * torch.from_numpy(diag_mask).to(dev).reshape(
            (1, nm, nw) + (1,) * nb
        )

        # W_l row 0: -base^i in the L block (static ints)
        base = np_
        row0_vals = [(N_INT - pow(base, i, N_INT)) % N_INT for i in range(nm)]
        row0 = sv.sv_const(row0_vals + [0] * (nw - nm), batch, device=dev)[:, None]

        # W_l rows 1..nm: [zeros(nm) | 1-eye(nm) | -(e+j)^-1 broadcast]
        mid = torch.zeros((16, nm, nm) + batch, dtype=f.DTYPE, device=dev)
        mid[0] = torch.from_numpy(
            (np.ones((nm, nm)) - np.eye(nm)).astype(np.int64)
        ).to(dev).reshape((nm, nm) + (1,) * nb)
        zeros_l = torch.zeros((16, nm, nm) + batch, dtype=f.DTYPE, device=dev)
        pole_block = neg_pole[:, None, :].expand((16, nm, np_) + batch)
        rows_rest = torch.cat([zeros_l, mid, pole_block], dim=2)
        W_l = torch.cat([row0, rows_rest], dim=1)

        a_m = sv.sv_const([1] * nm, batch, device=dev)
        a_l = sv.sv_zeros(nl, batch, device=dev)

        dim_np = np_

        def partition(typ: PartitionType, index: int):
            if typ == PartitionType.LL and index < dim_np:
                return index
            return None

        def collect_c(lambda_vec, mu_vec, mu_inv):
            """Closed forms of the circuit layer's collect_c for THIS W
            structure (W_m = -e diag in the R block; W_l = one -base^i row
            over L, (1 - I) over R, and the rank-1 pole block over O):
              c_nL[j] = -base^j * mu^-(j+1)
              c_nR[j] = (S - lam^(j+1) + e mu^(j+1)) * mu^-(j+1),
                         S = sum_{r=1..nm} lam^r
              c_lL[j] = -(e+j)^-1 * S  (j < np), zero-padded to nv
              c_nO = c_lR = c_lO = 0."""
            mu_inv_pows = sv.sv_powers(mu_inv, nm, start_at_one=False)
            lam_tail = lambda_vec[:, 1 : nm + 1]
            S = sv.sv_sum(lam_tail)
            bS = S[:, None].expand(lam_tail.shape)
            neg_base_v = sv.sv_const(row0_vals, batch, device=dev)
            c_nL = sv.sv_hadamard(neg_base_v, mu_inv_pows)
            c_nR = sv.sv_hadamard(
                sv.sv_add(sv.sv_sub(bS, lam_tail), sv.sv_scale(mu_vec, e)),
                mu_inv_pows,
            )
            zeros_nm = sv.sv_zeros(nm, batch, device=dev)
            zeros_nv = sv.sv_zeros(nv, batch, device=dev)
            c_lL = sv.sv_pad(sv.sv_scale(neg_pole, S), nv)
            return c_nL, c_nR, zeros_nm, c_lL, zeros_nv, zeros_nv

        return ArithmeticCircuitDevice(
            dim_nm=nm,
            dim_no=np_,
            k=1,
            dim_nl=nl,
            dim_nv=nv,
            dim_nw=nw,
            g=self.g,
            g_vec=self.g_vec,
            h_vec=self.h_vec,
            W_m=W_m,
            W_l=W_l,
            a_m=a_m,
            a_l=a_l,
            f_l=True,
            f_m=False,
            g_vec_=self.g_vec_,
            h_vec_=self.h_vec_,
            partition=partition,
            tables=self.tables,
            collect_c=collect_c,
        )


def _e_plus_j(e, np_: int):
    """[(e+0), (e+1), ..., (e+np-1)] as (16, np, *b) limbs."""
    js = sv.sv_const(list(range(np_)), tuple(e.shape[1:]), device=e.device)
    return f.fn_add(e[:, None], js)
