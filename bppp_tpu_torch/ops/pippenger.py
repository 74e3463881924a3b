"""Bucketed Pippenger MSM over many points per lane.

Counterpart of `bppp_tpu/ops/pippenger.py`, in the reference's
formulation, on the port's kernels. Per c-bit window:

  1. the window digits d_i; the points of each lane sorted by digit,
     descending (a stable argsort and a gather);
  2. inclusive prefix sums T_j = P_(0) + ... + P_(j) along the sorted axis,
     as ceil(log2 L) levels of one K5a launch each (`pt_add`: torch has no
     associative scan), the lanes past the start of a level added to the
     identity;
  3. the weighted bucket sum as a gather: with the points sorted
     descending, sum_b b S_b = sum_{t=1}^{2^c-1} T_{cnt_t - 1}, cnt_t =
     |{i : d_i >= t}|, T_{-1} the identity; the 2^c - 1 gathered points are
     summed by the complete pairwise tree `curve._tree_sum_axis1`;
  4. the windows fold MSB first: total = [2^c] total + window sum, the c
     doubles in one launch of the K5b chain (`cuda_curve.pt_double_chain`).

Every add is complete (K5a): sorted lanes hold equal points where the input
repeats a point, and the gathered row repeats an entry wherever two
thresholds have the same count. K7's `tree_sum`, whose slots use
incomplete adds, is never called here. The result is the same point as
`curve.msm`'s, not the same Jacobian limbs: compare results as points.
"""

from __future__ import annotations

import torch

from . import cuda_curve
from . import curve as dc
from .curve import PointJ


def _pick_c(L: int) -> int:
    """Window width by problem size, a divisor of the 16-bit limb width:
    per window about 2L adds (the scan) and 2^c - 1 (the gathered tree), so
    c = 8 pays for its 255-entry tree only above about 112 points."""
    return 8 if L > 112 else 4


def _digits_all(scalars, c: int):
    """(16, L, *b) limbs -> (256 / c, L, *b) int64 window digits, MSB
    window first."""
    per_limb = 16 // c
    rows = [(scalars[w // per_limb] >> (c * (w % per_limb))) & ((1 << c) - 1)
            for w in range(256 // c - 1, -1, -1)]
    return torch.stack(rows, dim=0)


def _prefix_pt_sum(p: PointJ) -> PointJ:
    """Inclusive prefix point sums along axis 1 of (16, L, *b) coordinates
    (Hillis-Steele: level k adds the point 2^k places back, complete adds;
    the first 2^k lanes of a level add the identity)."""
    L = p.x.shape[1]
    step = 1
    while step < L:
        ident = dc.identity((step,) + tuple(p.x.shape[2:]), device=p.x.device)
        back = PointJ(*(torch.cat([i, c[:, : L - step]], dim=1) for i, c in zip(ident, p)))
        p = dc.pt_add(p, back)
        step *= 2
    return p


def msm_pippenger(points: PointJ, scalars, c: int | None = None) -> PointJ:
    """sum_i [s_i] P_i. points: coords (16, L, *batch); scalars (16, L,
    *batch) F_n limbs (broadcast against the points). -> coords (16,
    *batch). c: window bits (default `_pick_c(L)`; must divide 16)."""
    L = points.x.shape[1]
    c = c or _pick_c(L)
    if 16 % c:
        raise ValueError(f"the window width must divide 16, got {c}")
    shape = torch.broadcast_shapes(points.x.shape, scalars.shape)
    batch = tuple(shape[2:])
    points = PointJ(*(a.expand(shape) for a in points))
    digs = _digits_all(scalars.expand(shape), c)  # (W, L, *b), MSB first
    dev = scalars.device
    n_ent = 1 << c
    thresholds = torch.arange(1, n_ent, device=dev).reshape((n_ent - 1, 1) + (1,) * len(batch))
    total = dc.identity(batch, device=dev)
    for w, d in enumerate(digs):
        if w:
            chain = cuda_curve.pt_double_chain(*total, c)  # (16, c, *b)
            total = PointJ(*(a[:, c - 1] for a in chain))
        order = torch.argsort(d, dim=0, descending=True, stable=True)  # (L, *b)
        idx = order[None].expand(shape)
        srt = PointJ(*(torch.gather(a, 1, idx) for a in points))
        pre = _prefix_pt_sum(srt)
        # T[0] = identity, T[j + 1] = prefix j: a count of 0 selects the identity
        ident = dc.identity((1,) + batch, device=dev)
        T = PointJ(*(torch.cat([i, a], dim=1) for i, a in zip(ident, pre)))
        cnt = (d[None] >= thresholds).sum(dim=1)  # (2^c - 1, *b): #digits >= t
        sel = PointJ(*(torch.gather(a, 1, cnt[None].expand((16,) + cnt.shape)) for a in T))
        total = dc.pt_add(total, dc._tree_sum_axis1(sel))
    return total
