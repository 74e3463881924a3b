"""Fixed-base MSM dispatch.

Counterpart of `bppp_tpu/ops/fixed_base.py`. With window tables present
the fixed generators ride the fixed-base kernel — the verifier's
`msm_mixed` adds the few per-proof points through the small-MSM kernel
and joins the two with one complete add; the prover's
`msm_fixed_positions` walks only the table rows a commitment touches —
and without tables everything goes through the generic shared-window MSM.
"""

from __future__ import annotations

import torch

from .cuda_fixed_base import DEFAULT_W, Tables, _digits, build_tables  # noqa: F401


def msm_mixed(tables, fixed_points, fixed_scalars, dyn_points, dyn_scalars):
    """MSM over fixed generators + a few per-proof dynamic points.
    fixed_scalars: (16, F, B) in TABLE order; fixed_points only feed the
    table-less path."""
    from . import cuda_fixed_base as cfb
    from . import curve as dc

    if tables is not None:
        fixed = dc.PointJ(*cfb.fixed_msm(tables, fixed_scalars))
        dyn_sum = dc.msm(dyn_points, dyn_scalars)
        return dc.pt_add(fixed, dyn_sum)
    pts = dc.PointJ(
        *(torch.cat([a, b], dim=1) for a, b in zip(fixed_points, dyn_points))
    )
    scs = torch.cat([fixed_scalars, dyn_scalars], dim=1)
    return dc.msm_straus(pts, scs)


def _straus_over(points, scalars):
    """Table-less route: a Straus MSM over `points` (coords (16, P,
    *pbatch), pbatch a suffix of the scalars' batch axes)."""
    from . import curve as dc

    extra = scalars.ndim - points.x.ndim
    if extra:
        idx = (slice(None), slice(None)) + (None,) * extra
        points = dc.PointJ(*(a[idx].expand(scalars.shape) for a in points))
    return dc.msm_straus(points, scalars)


def msm_fixed_positions(tables, points, positions, scalars):
    """MSM over a static SUBSET of the fixed-generator table layout:
    sum_j [scalars[:, j]] G_positions[j]. positions: tuple of static
    table indices (len P, any order, no duplicates); scalars:
    (16, P, *sbatch) in POSITION order; points: the FULL table-layout
    generator set (coords (16, F, ...)), used only when there are no
    tables.

    The kernel's cost is rows walked x windows adds per lane, so walking
    only the P live generators beats zero-padding into the full layout
    whenever P < F. The kernel reads those rows of the one table through
    a row index, uploaded once per position tuple and kept with the
    tables (`Tables.subset`); leading batch axes of the scalars flatten
    into lanes."""
    from . import cuda_fixed_base as cfb
    from . import curve as dc

    positions = tuple(positions)
    P = len(positions)
    if scalars.shape[1] != P:
        raise ValueError(f"{P} positions but scalars of shape {tuple(scalars.shape)}")
    if tables is not None:
        sbatch = tuple(scalars.shape[2:])
        s = cfb.fixed_msm(tables.subset(positions), scalars.reshape(16, P, -1))
        return dc.PointJ(*(a.reshape((16,) + sbatch) for a in s))
    idx = torch.tensor(positions, dtype=torch.int64, device=scalars.device)
    sub = dc.PointJ(*(a.index_select(1, idx) for a in points))
    return _straus_over(sub, scalars)


def msm_fixed_total(tables, points, scalars):
    """Complete MSM sum_i [s_i] P_i over ALL the fixed generators: rides
    the window tables when present, otherwise a Straus MSM over `points`
    (the same generators). scalars: (16, F, *sbatch) in TABLE order;
    points: coords (16, F, *pbatch) with pbatch a suffix of sbatch.
    -> PointJ coords (16, *sbatch). Zero scalars contribute the identity
    on both routes."""
    from . import cuda_fixed_base as cfb
    from . import curve as dc

    if tables is not None:
        F = scalars.shape[1]
        sbatch = tuple(scalars.shape[2:])
        s = cfb.fixed_msm(tables, scalars.reshape(16, F, -1))
        return dc.PointJ(*(a.reshape((16,) + sbatch) for a in s))
    return _straus_over(points, scalars)
