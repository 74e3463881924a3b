"""Lane-wise scalar multiplication (K6) and the sum of L points per lane
(K7): CUDA kernels of `csrc/ladder.cu`.

Counterpart of the ladder and tree halves of `bppp_tpu/ops/pallas_msm.py`.
Wrappers take and return int64 limb tensors in the interchange layout.
On a CUDA tensor a wrapper narrows to int32 storage, launches its kernel
on the current stream and widens the result, without synchronising; on a
CPU tensor — and only there — it runs the plain PyTorch version below.

K6 `scalar_mul` — replaces `pallas_msm._ladder_kernel` (`scalar_mul_flat`).
[k]P per lane. Bound on an H100: operations — per live lane 1 double and
13 adds for the table [1..15]P, 4 doubles per window below the top nonzero
one of the larger GLV half, one add per nonzero digit of either half,
beta's multiply and the join, against 448 bytes moved. At the paths' 4,096
to 132,096 lanes what holds it back is the series of dependent modular
multiplies of a lane, so the kernel halves the doubles with the GLV
endomorphism, computed inside the kernel (no eager decomposition: the
wrapper launches once): k = k1 + k2 lambda as `glv.decompose` does it,
each half walked over 33 four-bit windows with incomplete adds, phi and
the sign applied once to the k2 half's partial, and one complete add
joining the halves (`csrc/ladder.cu` has the argument why no walk add can
collide, whoever chose P and k). `scalar_mul_plan(B)` gives a lane two
threads (one half each, the table in shared memory) or one (both halves
on one accumulator, the table in its own array), from the sweep of both
launches on the card (`PERF.md`, `tools/compare_designs.py`). The plain
version is the 64-window ladder with complete adds, limb-equal to the JAX
package's graph ladder; kernel and plain version agree as POINTS
(compressed bytes), not in (X, Y, Z).

K7 `tree_sum` — replaces `pallas_msm._tree_kernel` (`tree_sum_flat`, and
the layout shuffle of `tree_sum`). (16, L, B) -> (16, B): L - 1 INCOMPLETE
adds per lane, in order (identity operands handled; a collision P == +-Q
degrades to the identity, which for sums of multiples of distinct
generators needs a discrete-log relation). Bound on an H100: bytes for
the short sums of the protocol ((3 L + 3) * 64 bytes per lane). The kernel
reads the (16, L, B) layout as it stands — adjacent threads read adjacent
lanes — so no copy rearranges the points first, and L is not padded.

For K7 kernel and plain version apply the same formulas in the same
order and with the same select order, so they agree in (X, Y, Z) limb for
limb, not only as points.
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

K6_BLOCK = 128  # threads per block at most (the kernel's MAX_THREADS)
K6_LANE_BLOCK = 64  # lanes per block of the one-thread-per-lane launch
# The split (two threads per lane) runs while its threads stay at most
# this many; beyond, the lane walk's third less work per lane beats the
# split's shorter series, whose shared tables (1,536 bytes a lane) also
# cap the blocks an SM holds. The sweep of both launches on the H100
# (`tools/compare_designs.py`, PERF.md): the split won up to 8192 lanes
# (1.35 ms against 1.65), and at 16384 (1.68 against 1.76, timed in
# turns); the lane walk from 17408 up (2.01 against 2.29 at 17408, 10.88
# against 11.75 at 132096). At 12288, which no path gives, the lane walk
# was 2 % ahead in turns. The paths run 4096-132096 lanes.
K6_SPLIT_THREADS = 32768


def scalar_mul_plan(B: int):
    """(threads per lane, lanes per block) of a K6 launch over B lanes: 2
    (one GLV half each) while 2 B <= K6_SPLIT_THREADS, as many lanes per
    block as K6_BLOCK threads hold; 1 beyond."""
    if 2 * B > K6_SPLIT_THREADS:
        return 1, K6_LANE_BLOCK
    return 2, K6_BLOCK // 2


# -- plain PyTorch versions ---------------------------------------------------


def scalar_mul_plain(px, py, pz, k):
    """[k]P by the plain 4-bit ladder in eager PyTorch, without GLV:
    complete adds for the table [0..15]P and the walk over all 64 windows
    of k, doubles before every window (the first four double the
    identity). The JAX package's graph ladder runs the same steps, so the
    two agree limb for limb; the kernel agrees with it as a point."""
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
    nthr, lpb = scalar_mul_plan(B)
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind("ladder", "bppp_scalar_mul", [_VP] * 7 + [ctypes.c_int] * 3 + [_VP])
    err = fn(*(t.data_ptr() for t in ins + outs), B, nthr, lpb, _build.stream())
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
