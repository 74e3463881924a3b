"""Lane-wise scalar multiplication (K6) and the sum of L points per lane
(K7): CUDA kernels of `csrc/ladder.cu`.

Counterpart of the ladder and tree halves of `bppp_tpu/ops/pallas_msm.py`.
Wrappers take and return int64 limb tensors in the interchange layout.
On a CUDA tensor a wrapper narrows to int32 storage, launches its kernel
on the current stream and widens the result, without synchronising; on a
CPU tensor — and only there — it runs the plain PyTorch version below.

K6 `scalar_mul` — replaces `pallas_msm._ladder_kernel` (`scalar_mul_flat`).
[k]P per lane: the table [0..15]P by 14 complete adds, then 64 four-bit
windows from the top, 4 doubles and one complete table add each. Bound on
an H100: operations (78 adds of 16 modular multiplies + 256 doubles of 7
per lane, 448 bytes moved). One launch holds the whole ladder: the
accumulator and the scalar stay in registers, the 1.5 KB table sits in
the thread's local memory and is indexed by the digit. The adds are
complete, since the mirror verifier feeds this kernel points and scalars
it did not choose.

K7 `tree_sum` — replaces `pallas_msm._tree_kernel` (`tree_sum_flat`, and
the layout shuffle of `tree_sum`). (16, L, B) -> (16, B): L - 1 INCOMPLETE
adds per lane, in order (identity operands handled; a collision P == +-Q
degrades to the identity, which for sums of multiples of distinct
generators needs a discrete-log relation). Bound on an H100: bytes for
the short sums of the protocol ((3 L + 3) * 64 bytes per lane). The kernel
reads the (16, L, B) layout as it stands — adjacent threads read adjacent
lanes — so no copy rearranges the points first, and L is not padded.

Kernel and plain version apply the same formulas in the same order and
with the same select order, so for both kernels they agree in (X, Y, Z)
limb for limb, not only as points.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import cuda_curve
from . import field as f
from .cuda_curve import flat_i32

_VP = _build.VP

LAUNCHES = {"scalar_mul": 0, "tree_sum": 0}
PLAIN_CALLS = {"scalar_mul": 0, "tree_sum": 0}


# -- plain PyTorch versions ---------------------------------------------------


def scalar_mul_plain(px, py, pz, k):
    """The same ladder in eager PyTorch: complete adds for the table and
    the walk, doubles before every window (the first four double the
    identity, as in the kernel)."""
    PLAIN_CALLS["scalar_mul"] += 1
    shape = torch.broadcast_shapes(px.shape, k.shape)
    P = tuple(c.expand(shape) for c in (px, py, pz))
    k = k.expand(shape)
    zero = torch.zeros_like(P[0])
    one = zero.clone()
    one[0] = 1
    ents = [(zero, one, zero), P]
    for _ in range(14):
        ents.append(cuda_curve.pt_add_plain(*ents[-1], *P))
    tab = [torch.stack([e[c] for e in ents], dim=0) for c in range(3)]  # (16 entries, *shape)
    acc = (zero, one, zero)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = cuda_curve.pt_double_plain(*acc)
        digit = (k[w // 4] >> (4 * (w % 4))) & 15  # shape[1:]
        idx = digit[None, None].expand((1,) + tuple(shape))
        sel = tuple(torch.gather(c, 0, idx)[0] for c in tab)
        acc = cuda_curve.pt_add_plain(*acc, *sel)
    return acc


def pt_add_inc_plain(px, py, pz, qx, qy, qz):
    """INCOMPLETE masked Jacobian add: the generic formulas plus the two
    identity selects (q identity, then p identity); no doubling and no
    inverse fix-up, so p == +-q gives Z3 = 0."""
    shape = torch.broadcast_shapes(px.shape, qx.shape)
    px, py, pz, qx, qy, qz = (c.expand(shape) for c in (px, py, pz, qx, qy, qz))
    Z1Z1 = f.fp_sqr(pz)
    Z2Z2 = f.fp_sqr(qz)
    U1 = f.fp_mul(px, Z2Z2)
    U2 = f.fp_mul(qx, Z1Z1)
    S1 = f.fp_mul(py, f.fp_mul(qz, Z2Z2))
    S2 = f.fp_mul(qy, f.fp_mul(pz, Z1Z1))
    H = f.fp_sub(U2, U1)
    r = f.fp_sub(S2, S1)
    HH = f.fp_sqr(H)
    HHH = f.fp_mul(H, HH)
    V = f.fp_mul(U1, HH)
    rr = f.fp_sqr(r)
    X3 = f.fp_sub(f.fp_sub(rr, HHH), f.fp_add(V, V))
    Y3 = f.fp_sub(f.fp_mul(r, f.fp_sub(V, X3)), f.fp_mul(S1, HHH))
    Z3 = f.fp_mul(f.fp_mul(pz, qz), H)
    p_id = f.fp_is_zero(pz)
    q_id = f.fp_is_zero(qz)
    out = (X3, Y3, Z3)
    out = tuple(torch.where(q_id, a, b) for a, b in zip((px, py, pz), out))
    return tuple(torch.where(p_id, a, b) for a, b in zip((qx, qy, qz), out))


def tree_sum_plain(x, y, z):
    """Axis 1 of (16, L, *batch) coordinates summed in order with L - 1
    incomplete adds, in eager PyTorch."""
    PLAIN_CALLS["tree_sum"] += 1
    acc = (x[:, 0], y[:, 0], z[:, 0])
    for l in range(1, x.shape[1]):
        acc = pt_add_inc_plain(*acc, x[:, l], y[:, l], z[:, l])
    return acc


# -- wrappers --------------------------------------------------------------------


def scalar_mul(px, py, pz, k):
    """[k]P per lane. px, py, pz: (16, *batch) int64 Jacobian coordinates;
    k: (16, *batch) int64 canonical F_n limbs; point and scalar broadcast
    against each other -> three (16, *batch) int64."""
    shape = torch.broadcast_shapes(px.shape, k.shape)
    if shape[0] != 16:
        raise ValueError(f"limb axis must have 16 entries, got shape {tuple(shape)}")
    if not px.is_cuda:
        return scalar_mul_plain(px, py, pz, k)
    ins = [flat_i32(c, shape) for c in (px, py, pz, k)]
    B = ins[0].shape[1]
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind("ladder", "bppp_scalar_mul", [_VP] * 7 + [ctypes.c_int, _VP])
    err = fn(*(t.data_ptr() for t in ins + outs), B, _build.stream())
    LAUNCHES["scalar_mul"] += 1
    _build.check(err, "scalar_mul")
    return tuple(o.to(torch.int64).reshape(shape) for o in outs)


def tree_sum(x, y, z):
    """Sum of the L points of axis 1. x, y, z: (16, L, *batch) int64
    Jacobian coordinates, L >= 1 -> three (16, *batch) int64."""
    shape = x.shape
    if x.ndim < 2 or shape[0] != 16 or y.shape != shape or z.shape != shape:
        raise ValueError("points must be three (16, L, *batch) tensors")
    L = shape[1]
    if L < 1:
        raise ValueError("tree_sum needs at least one point per lane")
    if not x.is_cuda:
        return tree_sum_plain(x, y, z)
    ins = [flat_i32(c, shape).reshape(16, L, -1) for c in (x, y, z)]
    B = ins[0].shape[2]
    outs = [torch.empty((16, B), dtype=torch.int32, device=x.device) for _ in range(3)]
    fn = _build.bind("ladder", "bppp_tree_sum", [_VP] * 6 + [ctypes.c_int, ctypes.c_int, _VP])
    err = fn(*(t.data_ptr() for t in ins + outs), L, B, _build.stream())
    LAUNCHES["tree_sum"] += 1
    _build.check(err, "tree_sum")
    out_shape = (16,) + tuple(shape[2:])
    return tuple(o.to(torch.int64).reshape(out_shape) for o in outs)
