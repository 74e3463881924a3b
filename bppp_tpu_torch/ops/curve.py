"""secp256k1 group operations on limb tensors (PyTorch).

Counterpart of the core half of `bppp_tpu/ops/curve.py`. A point is a
`PointJ` of Jacobian coordinates, each a (16, *batch) int64 limb tensor
(see `ops/field.py`); z == 0 encodes the identity. All exceptional cases
(identity operands, doubling collision, P + (-P)) are handled with lane
masks. Vectors of points carry the length axis at position 1:
coordinates (16, L, *batch).

Which code runs is decided by where the tensor lies and by nothing else:
on a CUDA tensor `pt_add`, `pt_double`, `pt_scalar_mul`, `pt_sum`, the
small MSM, the fixed-window exponentiations and Keccak each launch their
kernel (or raise); on a CPU tensor their plain PyTorch versions run.

The bucketed Pippenger MSM is `ops/pippenger.py`; `msm` over more than
`MSM_SMALL_MAX` points takes ladder + sum, and which route it should take
on this card is for a measurement to decide (`PERF.md`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..oracle import curve as oc
from ..oracle.field import B as B_INT
from . import cuda_curve, cuda_ladder
from . import field as f

MSM_SMALL_MAX = 6  # `msm` hands at most this many points per lane to the small-MSM kernel


class PointJ(NamedTuple):
    """Jacobian point, limb-major; z == 0 <=> identity."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch(self):
        return tuple(self.x.shape[1:])


B7 = f.int_to_limbs(B_INT)  # curve b = 7


def pt_select(mask, a: PointJ, b: PointJ) -> PointJ:
    """mask: (*batch,) bool -> limbwise select."""
    return PointJ(*(torch.where(mask, x, y) for x, y in zip(a, b)))


def identity(batch=(), device="cuda") -> PointJ:
    z16 = torch.zeros((16,) + tuple(batch), dtype=f.DTYPE, device=device)
    one = z16.clone()
    one[0] = 1
    return PointJ(z16, one, z16.clone())


def generator(batch=(), device="cuda") -> PointJ:
    return from_int_points([oc.GENERATOR], batch=batch, squeeze=True, device=device)


def from_int_points(pts, batch=(), squeeze=False, device="cuda") -> PointJ:
    """Host: list of oracle Points -> PointJ with coords (16, L, *batch).

    With squeeze=True and one point, coords are (16, *batch)."""
    batch = tuple(batch)

    def lift(vals):
        a = torch.from_numpy(f.ints_to_limbs(vals)).to(device)  # (16, L)
        if squeeze and len(pts) == 1:
            a = a[:, 0].reshape((16,) + (1,) * len(batch))
            return a.expand((16,) + batch).contiguous()
        a = a.reshape((16, len(pts)) + (1,) * len(batch))
        return a.expand((16, len(pts)) + batch).contiguous()

    return PointJ(
        lift([p.x for p in pts]), lift([p.y for p in pts]), lift([p.z for p in pts])
    )


def to_int_points(p: PointJ) -> list[oc.Point]:
    """Host: PointJ with coords (16, L) -> list of oracle Points."""
    xs, ys, zs = (f.limbs_to_ints(f._np(c).reshape(16, -1)) for c in p)
    return [oc.Point(x, y, z) for x, y, z in zip(xs, ys, zs)]


def pt_is_identity(p: PointJ):
    return f.fp_is_zero(p.z)


def pt_neg(p: PointJ) -> PointJ:
    return PointJ(p.x, f.fp_neg(p.y), p.z)


def pt_double(p: PointJ) -> PointJ:
    """dbl-2009-l (a=0). Complete for identity/order-2 inputs: Z3 = 2YZ
    vanishes exactly when the oracle's double returns the identity."""
    return PointJ(*cuda_curve.pt_double(*p))


def pt_add(p: PointJ, q: PointJ) -> PointJ:
    """Complete masked Jacobian add, matching the oracle's add; operands
    broadcast against each other."""
    return PointJ(*cuda_curve.pt_add(*p, *q))


def pt_scalar_mul(p: PointJ, k) -> PointJ:
    """[k]p lane-wise, 4-bit fixed windows (`ops/cuda_ladder.scalar_mul`).
    k: (16, *batch) canonical F_n limbs; point and scalar broadcast
    against each other."""
    return PointJ(*cuda_ladder.scalar_mul(*p, k))


def pt_sum(p: PointJ, axis: int = 1) -> PointJ:
    """Reduce a points axis (default axis 1 of (16, L, *batch)) to a single
    point (`ops/cuda_ladder.tree_sum`). The adds are incomplete: identity
    entries are inert, a collision of two partial sums degrades to the
    identity."""
    if axis != 1:
        p = PointJ(*(c.movedim(axis, 1) for c in p))
    if p.x.shape[1] == 1:
        return PointJ(*(c[:, 0] for c in p))
    return PointJ(*cuda_ladder.tree_sum(*p))


def small_msm_variant() -> str:
    """The small-MSM kernel `msm` takes, read from the environment on every
    call with the reference's meaning (`bppp_tpu/ops/curve.py:449-451` and
    `:491-519`; a switch is off only when it is "0"):

      BPPP_GLV=0                 -> "msm_small"       K9, plain 64-window walk
      BPPP_WNAF=0 (GLV on)       -> "msm_small_glv"   K8, GLV, unsigned digits
      otherwise (the default)    -> "msm_small_wnaf"  K4, GLV, signed digits

    The switches choose between three kernels, never between a kernel and
    a plain version. The name is the kernel's wrapper in `ops/cuda_msm.py`
    and its launch-counter key."""
    if os.environ.get("BPPP_GLV", "1") == "0":
        return "msm_small"
    if os.environ.get("BPPP_WNAF", "1") == "0":
        return "msm_small_glv"
    return "msm_small_wnaf"


def msm(points: PointJ, scalars) -> PointJ:
    """Multi-scalar multiplication sum_i [s_i] P_i: points coords
    (16, L, *batch), scalars (16, L, *batch) F_n limbs, broadcast against
    each other. Up to `MSM_SMALL_MAX` points per lane — the verifier's
    per-round folds and commitment chain — take a shared-window kernel,
    the one `small_msm_variant()` names: by default each scalar is split
    by the GLV endomorphism (`ops/glv.py`) and recoded to signed 4-bit
    digits, and one 33-window walk does the rest
    (`ops/cuda_msm.msm_small_wnaf`). More points than the kernel takes per
    call (`cuda_msm.DMAX`, `DMAX_U4`) run as chunks combined with one
    complete add each. More than `MSM_SMALL_MAX` points run as one ladder
    over all L * batch lanes and one sum over L."""
    from . import cuda_msm

    L = points.x.shape[1]
    if L < 1:
        raise ValueError("msm needs at least one point")
    shape = torch.broadcast_shapes(points.x.shape, scalars.shape)
    if L > MSM_SMALL_MAX:
        # the kernels take what they are given: expand shared generators first
        pts = PointJ(*(c.expand(shape) for c in points))
        return pt_sum(pt_scalar_mul(pts, scalars.expand(shape)), axis=1)
    batch = tuple(shape[2:])
    prod = 1
    for d in batch:
        prod *= d
    pts = [c.expand(shape).reshape(16, L, prod) for c in points]
    kk = scalars.expand(shape).reshape(16, L, prod)

    variant = small_msm_variant()
    dmax = cuda_msm.DMAX if variant == "msm_small_wnaf" else cuda_msm.DMAX_U4
    acc = None
    for lo in range(0, L, dmax):
        hi = min(lo + dmax, L)
        coords = [c[:, lo:hi].movedim(1, 0).contiguous() for c in pts]  # (D, 16, prod)
        part = PointJ(*_msm_small_call(variant, coords, kk[:, lo:hi]))
        # chunks are independent random points: complete add
        acc = part if acc is None else pt_add(acc, part)
    return PointJ(*(c.reshape((16,) + batch) for c in acc))


def _msm_small_call(variant: str, coords, k):
    """One small-MSM kernel call: coords three (D, 16, B), k (16, D, B)."""
    from . import cuda_msm, glv

    if variant == "msm_small":
        return cuda_msm.msm_small(*coords, k.movedim(1, 0).contiguous())
    if variant == "msm_small_glv":
        return cuda_msm.msm_small_glv(*coords, *glv.glv_halves(k))
    return cuda_msm.msm_small_wnaf(*coords, glv.wnaf_planes(k))


def _tree_sum_axis1(p: PointJ) -> PointJ:
    """Log-depth pairwise reduction of the points axis (axis 1) with
    complete adds; an odd leftover rides along to the next level."""
    L = p.x.shape[1]
    while L > 1:
        half = L // 2
        s = pt_add(
            PointJ(*(c[:, :half] for c in p)),
            PointJ(*(c[:, half : 2 * half] for c in p)),
        )
        if L % 2:
            s = PointJ(*(torch.cat([a, b[:, 2 * half :]], dim=1) for a, b in zip(s, p)))
        p = s
        L = p.x.shape[1]
    return PointJ(*(c[:, 0] for c in p))


def msm_straus(points: PointJ, scalars) -> PointJ:
    """Interleaved shared-window MSM (Straus): the plain eager version of
    the MSMs, for any number of points. 4-bit windows: per point the table
    [0..15]P (14 complete adds), the points every window selects summed for
    all 64 windows at once (one log tree over L), then the window sums
    folded MSB first, 4 doubles (one K5b chain) and one add per window."""
    L = points.x.shape[1]
    shape = torch.broadcast_shapes(points.x.shape, scalars.shape)
    points = PointJ(*(c.expand(shape) for c in points))
    scalars = scalars.expand(shape)
    batch = tuple(shape[2:])
    dev = scalars.device

    # tables tab[e] = [e]P_i, e = 0..15: coords (16ent, 16, L, *batch)
    ents = [identity((L,) + batch, device=dev), points]
    for _ in range(14):
        ents.append(pt_add(ents[-1], points))
    tab = PointJ(*(torch.stack(cs, dim=0) for cs in zip(*ents)))

    digits = torch.stack([(scalars[w // 4] >> (4 * (w % 4))) & 15 for w in range(64)])
    idx = digits[:, None].expand((64, 16, L) + batch)
    sel = PointJ(*(torch.gather(c, 0, idx).movedim(0, 2) for c in tab))  # (16, L, 64, *batch)
    wins = _tree_sum_axis1(sel)  # (16, 64, *batch): window w's sum
    acc = PointJ(*(c[:, 63] for c in wins))
    for w in range(62, -1, -1):
        acc = PointJ(*(c[:, 3] for c in cuda_curve.pt_double_chain(*acc, 4)))
        acc = pt_add(acc, PointJ(*(c[:, w] for c in wins)))
    return acc


def to_affine(p: PointJ):
    """-> (x_aff, y_aff, is_id). Identity lanes yield (0, 0, True);
    fp_inv(0) = 0 under the Fermat ladder so no masking is needed before
    the inversion."""
    is_id = pt_is_identity(p)
    zi = f.fp_inv(p.z)
    zi2 = f.fp_sqr(zi)
    x = f.fp_mul(p.x, zi2)
    y = f.fp_mul(p.y, f.fp_mul(zi2, zi))
    x = torch.where(is_id, torch.zeros_like(x), x)
    y = torch.where(is_id, torch.zeros_like(y), y)
    return x, y, is_id


def compress(p: PointJ):
    """SEC1 compressed encoding -> (33, *batch) int64 byte tensor:
    0x02 | (y & 1) prefix + big-endian x; identity -> 33 zero bytes."""
    x, y, is_id = to_affine(p)
    xb = f.limbs_to_be_bytes(x)  # (32, *batch); zero on identity lanes
    tag = torch.where(is_id, torch.zeros_like(y[0]), 2 + (y[0] & 1))
    return torch.cat([tag[None], xb], dim=0)


def _curve_rhs(x):
    return f.fp_add(f.fp_mul(f.fp_sqr(x), x), f._const(B7, x))


def _decompress(b):
    tag = b[0]
    x = f.be_bytes_to_limbs(b[1:])
    rhs = _curve_rhs(x)
    y = f.fp_sqrt(rhs)
    flip = (y[0] & 1) != (tag & 1)
    y = torch.where(flip, f.fp_neg(y), y)
    is_id = (b == 0).all(dim=0)
    one = torch.zeros_like(x)
    one[0] = 1
    z = torch.where(is_id, torch.zeros_like(x), one)
    y = torch.where(is_id, one, y)
    return PointJ(x, y, z), x, rhs, is_id


def decompress(b) -> PointJ:
    """(33, *batch) SEC1 bytes -> PointJ. All-zero lanes -> identity.
    Assumes well-formed input."""
    return _decompress(b)[0]


def decompress_checked(b):
    """(33, *batch) SEC1 bytes -> (PointJ, ok mask). Does NOT trust its
    input: raw wire bytes reach the verifier without a host deserializer.
    ok lanes are: the all-zero identity encoding, OR tag in {2, 3} with
    canonical x < p and x^3 + 7 a quadratic residue (the sqrt ladder's
    output actually squares back to the right-hand side). Callers fold
    ~ok into their accept bit; invalid lanes still decode to SOME defined
    point so downstream arithmetic stays total, and nothing raises."""
    pt, x, rhs, is_id = _decompress(b)
    tag = b[0]
    tag_ok = (tag == 2) | (tag == 3)
    x_canon = f.limbs_lt_const(x, f.P_INT)
    on_curve = (f.fp_sqr(pt.y) == rhs).all(dim=0)
    ok = is_id | (tag_ok & x_canon & on_curve)
    # a "byte" outside [0, 255] would alias a different x under
    # be_bytes_to_limbs and slip past x_canon — reject it here so every
    # encoding has exactly one accepted representation
    bytes_ok = ((b >= 0) & (b <= 0xFF)).all(dim=0)
    return pt, ok & bytes_ok


def pt_eq(p: PointJ, q: PointJ):
    """Projective equality mask (as the oracle's eq)."""
    Z1Z1 = f.fp_sqr(p.z)
    Z2Z2 = f.fp_sqr(q.z)
    x_eq = (f.fp_mul(p.x, Z2Z2) == f.fp_mul(q.x, Z1Z1)).all(dim=0)
    y_eq = (
        f.fp_mul(p.y, f.fp_mul(q.z, Z2Z2)) == f.fp_mul(q.y, f.fp_mul(p.z, Z1Z1))
    ).all(dim=0)
    p_id = pt_is_identity(p)
    q_id = pt_is_identity(q)
    either_id = p_id | q_id
    return torch.where(either_id, p_id == q_id, x_eq & y_eq & ~either_id)
