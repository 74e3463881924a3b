"""u64 range proof, batched — the flagship entry point.

Counterpart of `bppp_tpu/protocol/u64.py`. Fixed instantiation of the
reciprocal protocol: base 16, 16 hex digits; g_vec = 16, h_vec = 26
circuit + 6 WNLA padding = 32. A proof is 13 group elements + 3 scalars
per value.

Values enter as (2, *batch) int64 tensors of 32-bit (lo, hi) halves; the
digit and multiplicity decomposition runs on the tensor's device with
static shifts and one-hot counting.
"""

from __future__ import annotations

import torch

from ..ops import curve as dc
from ..ops.curve import PointJ
from ..ops.fixed_base import DEFAULT_W, build_tables
from ..transcript.device import Transcript
from . import points as pv
from .reciprocal import (
    ReciprocalProofBytes,
    ReciprocalProofDev,
    ReciprocalRangeProofDevice,
    ReciprocalWitnessDev,
    reciprocal_blind_draws,
)

G_VEC_FULL_SZ = 16
H_VEC_CIRCUIT_SZ = 26
H_VEC_FULL_SZ = 32
DIM_ND = 16
DIM_NP = 16

U64_BLIND_DRAWS = reciprocal_blind_draws(DIM_ND)  # 52


class U64RangeProofDevice:
    """g: PointJ (16, *batch); g_vec: (16, 16, *batch); h_vec:
    (16, 32, *batch); tables: optional fixed-base window tables from
    `build_u64_tables` — {'full': the 49-point set [g | h_vec | g_vec]
    for the WNLA final MSM, 'gv': the [g | g_vec] subset for the circuit
    layer's MSM}."""

    def __init__(self, g: PointJ, g_vec: PointJ, h_vec: PointJ, tables=None):
        assert pv.pv_len(g_vec) == G_VEC_FULL_SZ
        assert pv.pv_len(h_vec) == H_VEC_FULL_SZ
        self.g, self.g_vec, self.h_vec = g, g_vec, h_vec
        self.tables = tables

    @property
    def batch(self):
        return tuple(self.g.x.shape[1:])

    def _reciprocal(self) -> ReciprocalRangeProofDevice:
        empty = dc.identity((0,) + self.batch, device=self.g.x.device)
        return ReciprocalRangeProofDevice(
            dim_nd=DIM_ND,
            dim_np=DIM_NP,
            g=self.g,
            g_vec=self.g_vec,
            h_vec=PointJ(*(a[:, :H_VEC_CIRCUIT_SZ] for a in self.h_vec)),
            g_vec_=empty,
            h_vec_=PointJ(*(a[:, H_VEC_CIRCUIT_SZ:] for a in self.h_vec)),
            tables=self.tables,
        )

    def commit_value(self, x_words, s) -> PointJ:
        """x_words: (2, *batch) int64 (lo, hi) 32-bit halves; s:
        (16, *batch) limbs -> the value commitment x*g + s*h_vec[0]."""
        return self._reciprocal().commit_value(u64_to_limbs(x_words), s)

    def prove(self, x_words, s, t: Transcript, blind) -> ReciprocalProofDev:
        """blind: (16, U64_BLIND_DRAWS, *batch) blinding stream in the
        reference's draw order."""
        witness = ReciprocalWitnessDev(
            x=u64_to_limbs(x_words),
            s=s,
            m=u64_to_hex_mapped(x_words),
            digits=u64_to_hex(x_words),
        )
        recip = self._reciprocal()
        commitment = recip.commit_value(witness.x, witness.s)
        return recip.prove(commitment, witness, t, blind)

    def verify(
        self,
        commitment_bytes,
        t: Transcript,
        proof: ReciprocalProofBytes,
        fast: bool = False,
    ):
        """commitment_bytes: (33, *batch) SEC1 bytes of the value
        commitment -> (*batch,) bool accept mask. fast=True runs the
        collapsed one-MSM verifier, fast=False the mirror verifier that
        folds the generators per round: same transcript, same
        accept/reject set."""
        return self._reciprocal().verify(commitment_bytes, t, proof, fast=fast)


def build_u64_tables(g: PointJ, g_vec: PointJ, h_vec: PointJ, w_bits: int = DEFAULT_W):
    """Fixed-base window tables for a u64 generator set. Inputs are the
    UNBATCHED points (coords (16,) / (16, L)). -> dict for
    U64RangeProofDevice(tables=...)."""
    pts = PointJ(
        *(torch.cat([a[:, None], b, c], dim=1) for a, b, c in zip(g, h_vec, g_vec))
    )  # [g | h(32) | g_vec(16)] -> (16, 49)
    tab = build_tables(pts, w_bits)
    # the circuit MSM's subset [g | g_vec]: a row view of the same table
    gv = tab.take([0] + list(range(1 + H_VEC_FULL_SZ, 1 + H_VEC_FULL_SZ + G_VEC_FULL_SZ)))
    return {"full": tab, "gv": gv}


def u64_to_limbs(x_words):
    """(2, *batch) (lo, hi) 32-bit halves -> (16, *batch) F_n limbs."""
    lo, hi = x_words[0], x_words[1]
    limbs = [lo & 0xFFFF, (lo >> 16) & 0xFFFF, hi & 0xFFFF, (hi >> 16) & 0xFFFF]
    zero = torch.zeros_like(lo)
    return torch.stack(limbs + [zero] * 12, dim=0)


def u64_digits(x_words):
    """(2, *batch) -> (16, *batch) hex-digit values (0..15),
    least-significant first."""
    lo, hi = x_words[0], x_words[1]
    digs = [(lo >> (4 * i)) & 15 for i in range(8)]
    digs += [(hi >> (4 * i)) & 15 for i in range(8)]
    return torch.stack(digs, dim=0)


def _as_limb0(vals):
    """(L, *batch) small values -> (16, L, *batch) limbs."""
    out = vals.new_zeros((16,) + tuple(vals.shape))
    out[0] = vals
    return out


def u64_to_hex(x_words):
    """(2, *batch) -> (16, nd=16, *batch) digit limbs."""
    return _as_limb0(u64_digits(x_words))


def u64_to_hex_mapped(x_words):
    """Digit multiplicities: out[:, v] = #digits == v, as
    (16, np=16, *batch) limbs."""
    d = u64_digits(x_words)  # (16, *batch)
    counts = torch.stack([(d == v).sum(dim=0) for v in range(16)], dim=0)
    return _as_limb0(counts)
