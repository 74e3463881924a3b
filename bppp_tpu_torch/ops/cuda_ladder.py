"""Lane-wise scalar multiplication (K6) and the sum of L points per lane
(K7): CUDA kernels of `csrc/ladder.cu`.

Counterpart of the ladder and tree halves of `bppp_tpu/ops/pallas_msm.py`.
Wrappers take and return int64 limb tensors in the interchange layout.
On a CUDA tensor a wrapper launches its kernel on the current stream,
without synchronising — K6 narrows to int32 storage first and widens the
result, K7 reads and writes the int64 limbs where they lie; on a CPU
tensor — and only there — it runs the plain PyTorch version below.

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
the layout shuffle of `tree_sum`). (16, L, *batch) -> (16, *batch).
Bound on an H100: bytes ((3 L + 3) * 128 bytes of int64 limbs per lane)
against L - 1 adds. One thread walking a lane's L - 1 adds in order is a
series of L - 1 adds on a few SMs, so `tree_sum_plan(L, B)` gives a lane
n threads: slot s sums its contiguous share of the points in order with
INCOMPLETE adds (identity operands handled; a collision P == +-Q degrades
to the identity, which for sums of multiples of distinct generators needs
a discrete-log relation, as in the sequential order), and the n partials
join by `csrc/join.cuh`'s fixed tree of COMPLETE adds. The kernel reads
the coordinates where they lie (a limb, a point and a lane stride each),
so a call is one launch, and L is not padded.

Kernel and plain version add in another order, so they agree as POINTS
(compressed bytes), not in (X, Y, Z): `tree_sum_plain` is the sequential
chain, the reference's order, and the CPU path. `tree_sum_slots_plain`
runs the kernel's order — each slot's incomplete adds, then the join's
complete adds — and agrees with the kernel limb for limb.
"""

from __future__ import annotations

import ctypes
import math

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
    X3, Y3, Z3, _, _ = cuda_curve._add_formula(px, py, pz, qx, qy, qz)
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


def slot_bounds(L: int, n: int):
    """[(lo, hi)] of K7's n slots over L points: slot s sums points
    lo <= l < hi, as the kernel computes them (empty where n > L)."""
    return [(s * L // n, (s + 1) * L // n) for s in range(n)]


def tree_sum_slots_plain(x, y, z, n: int):
    """K7's order in eager PyTorch, for n slots per lane: slot s sums its
    points (`slot_bounds`) in order with incomplete adds, an empty slot
    holds the identity (0, 1, 0), and the n partials join as
    `csrc/join.cuh` joins them — while m > 1 slots are left, h = ceil(m /
    2) and slot s < m - h adds slot s + h with a complete add. The same
    formulas in the same order as the kernel, so the limbs agree."""
    L = x.shape[1]
    bounds = slot_bounds(L, n)
    acc = [torch.zeros((16, n) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
           for _ in range(3)]
    acc[1][0] = 1
    for j in range(max(hi - lo for lo, hi in bounds)):
        live = [s for s, (lo, hi) in enumerate(bounds) if lo + j < hi]
        slots = torch.tensor(live, device=x.device)
        pts = torch.tensor([bounds[s][0] + j for s in live], device=x.device)
        q = [c[:, pts] for c in (x, y, z)]
        if j:
            q = pt_add_inc_plain(*(a[:, slots] for a in acc), *q)
        for a, v in zip(acc, q):
            a[:, slots] = v
    m = n
    while m > 1:
        h = (m + 1) // 2
        k = m - h
        s = cuda_curve.pt_add_plain(*(a[:, :k] for a in acc), *(a[:, h:m] for a in acc))
        for a, v in zip(acc, s):
            a[:, :k] = v
        m = h
    return tuple(a[:, 0] for a in acc)


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


# K7's launch: n slots per lane, K7_LPB lanes per block (more where the
# slots fill less than a warp). The sweep on the H100 (device ms per launch,
# `tools/compare_designs.py`, PERF.md) at 1024 lanes: L = 17 best at n = 8
# (0.0575; n = 1 0.1446, n = 16 0.0594), L = 33 at n = 16 (0.0674), L = 65
# at n = 16 (0.0875; n = 32 0.0911), L = 129 at n = 32 or 16 (0.1410,
# 0.1439; n = 1 1.1764), and the ragged (7, 93) at n = 4 (0.0399): about
# two points a slot, while n B stays within K7_THREADS; 8 lanes per block
# within 10 % of 16 and 32 wherever n >= 4.
K7_BLOCK = 256  # threads per block at most (the kernel's TREE_MAX_THREADS)
K7_LPB = 8
K7_MAX_SLOTS = 32
K7_THREADS = 16384


def tree_sum_plan(L: int, B: int) -> tuple[int, int]:
    """(slots per lane, lanes per block) of K7's launch over B lanes of L
    points: n the largest power of two at most ceil(L / 2), K7_MAX_SLOTS
    and K7_THREADS / B (at least 1); lanes per block K7_LPB, or as many as
    fill a warp."""
    n = 1
    while 2 * n <= min(-(-L // 2), K7_MAX_SLOTS) and 2 * n * B <= K7_THREADS:
        n *= 2
    return n, max(K7_LPB, 32 // n)


def _sum_view(t: torch.Tensor):
    """A (16, L, *batch) int64 coordinate on the card as K7 reads it:
    (tensor, limb stride, point stride, lane stride). The tensor is t
    itself where its batch axes fold into one strided axis, else one
    contiguous copy."""
    cuda_curve._check_operand(t)
    st = cuda_curve.lane_strides((16,) + tuple(t.shape[2:]), (t.stride(0),) + t.stride()[2:])
    if st is None:
        t = t.contiguous()
        st = cuda_curve.lane_strides((16,) + tuple(t.shape[2:]), (t.stride(0),) + t.stride()[2:])
    return t, st[0], t.stride(1), st[1]


def tree_sum_launch(x, y, z, n: int, lpb: int):
    """Launch K7 with n slots per lane and lpb lanes per block on three
    (16, L, *batch) int64 coordinates -> three (16, *batch) int64."""
    shape = x.shape
    views = [_sum_view(c) for c in (x, y, z)]
    outs = torch.empty((3, 16) + tuple(shape[2:]), dtype=torch.int64, device=x.device).unbind(0)
    fn = _build.bind("ladder", "bppp_tree_sum",
                     [ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_VP)]
                     + [ctypes.c_int] * 4 + [_VP])
    ptrs = (_VP * 3)(*(v[0].data_ptr() for v in views))
    strides = (ctypes.c_longlong * 9)(*(s for v in views for s in v[1:]))
    optrs = (_VP * 3)(*(o.data_ptr() for o in outs))
    err = fn(ptrs, strides, optrs, shape[1], math.prod(shape[2:]), n, lpb, _build.stream())
    LAUNCHES["tree_sum"] += 1
    _build.check(err, "tree_sum")
    return tuple(outs)


def tree_sum(x, y, z):
    """Sum of the L points of axis 1. x, y, z: (16, L, *batch) int64
    Jacobian coordinates, L >= 1 -> three (16, *batch) int64. One launch:
    the kernel reads the coordinates where they lie."""
    shape = x.shape
    if x.ndim < 2 or shape[0] != 16 or y.shape != shape or z.shape != shape:
        raise ValueError("points must be three (16, L, *batch) tensors")
    L = shape[1]
    if L < 1:
        raise ValueError("tree_sum needs at least one point per lane")
    if not x.is_cuda:
        return tree_sum_plain(x, y, z)
    return tree_sum_launch(x, y, z, *tree_sum_plan(L, math.prod(shape[2:])))
