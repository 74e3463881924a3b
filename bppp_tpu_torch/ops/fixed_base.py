"""Fixed-base MSM dispatch for the verifier.

Counterpart of `bppp_tpu/ops/fixed_base.py` (its `msm_mixed`; the
prover's `msm_fixed_positions` / `msm_fixed_total` follow with the
prover). With window tables present the fixed generators ride the
fixed-base kernel and the few per-proof points the small-MSM kernel,
joined by one complete add; without tables everything goes through the
generic shared-window MSM.
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
