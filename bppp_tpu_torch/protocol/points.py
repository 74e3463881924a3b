"""Batched point-vector helpers (twin of the point side of
oracle/vectors.py). Counterpart of `bppp_tpu/protocol/points.py`. Point vectors are `PointJ`s with
coordinates (16, L, *batch); identity padding mirrors the reference's
`vector_extend`."""

from __future__ import annotations

import torch

from ..ops import curve as c
from ..ops.curve import PointJ
from . import vectors as v


def pv_len(p: PointJ) -> int:
    return p.x.shape[1]


def pv_pad(p: PointJ, L: int) -> PointJ:
    """Identity-pad the length axis (axis 1) to L."""
    have = pv_len(p)
    if have == L:
        return p
    assert have < L
    idl = c.identity((L - have,) + tuple(p.x.shape[2:]), device=p.x.device)
    return PointJ(*(torch.cat([a, b], dim=1) for a, b in zip(p, idl)))


def pv_split(p: PointJ):
    """Even/odd split along the length axis."""
    return (
        PointJ(*(a[:, 0::2] for a in p)),
        PointJ(*(a[:, 1::2] for a in p)),
    )


def pv_concat(parts) -> PointJ:
    return PointJ(*(torch.cat(cs, dim=1) for cs in zip(*parts)))


def pv_add(p: PointJ, q: PointJ) -> PointJ:
    L = max(pv_len(p), pv_len(q))
    return c.pt_add(pv_pad(p, L), pv_pad(q, L))


def pv_scale(p: PointJ, s) -> PointJ:
    """[s]p lane-wise; s a (16, *batch) scalar shared across the vector."""
    return c.pt_scalar_mul(p, s[:, None])


def msm(points: PointJ, scalars) -> PointJ:
    """sum_i [s_i] P_i with zero/identity padding."""
    L = max(pv_len(points), scalars.shape[1])
    return c.msm(pv_pad(points, L), v.sv_pad(scalars, L))


def single(p: PointJ) -> PointJ:
    """Insert a length axis: (16, *batch) coords -> (16, 1, *batch)."""
    return PointJ(*(a[:, None] for a in p))
