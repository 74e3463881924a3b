"""Lane-wise Jacobian point add and chains of doubles: CUDA kernels K5a / K5b.

Counterpart of `bppp_tpu/ops/pallas_curve.py`. The wrappers take and
return the interchange layout: coordinates as (16, *batch) int64 limb
tensors. On a CUDA tensor a wrapper launches its kernel from
`csrc/curve.cu` on the current stream and never synchronises; K5b and
`affine_rows` narrow to int32 storage first and widen the result, K5a
reads and writes the int64 limbs where they lie. On a CPU tensor — and
only there — a wrapper runs the plain PyTorch version below.

Replaces: `pallas_curve._pt_add_kernel` (`pt_add_flat`) and
`pallas_curve._pt_double_kernel` (`pt_double_flat`).

K5a `pt_add`: bound on an H100 by bytes. It moves 9 * 128 bytes per lane
(int64 limbs; a broadcast operand's one lane once) and does 16 modular
multiplies (23 on a doubling collision). The paths add a few points per
proof, 1,024 lanes, where one thread per lane runs the 16 products in a
row on a nearly empty card. The formula is 5 products deep, so T threads
of one warp share a lane and split each dependency level's products,
passing the results by warp shuffle (`pt_add_plan`: 4 threads up to 8,192
lanes, 2 beyond, up to the table build's 200,704; one thread per lane was
slower at every batch measured). Each operand goes to the kernel as a
pointer, a limb stride and a lane stride (`lane_view`: 0 for an operand
broadcast over the batch), so a call is one launch; only an operand whose
batch axes do not fold into one strided axis is copied first.

K5b `pt_double_chain`: the n successive doubles [2^t] P, t = 1..n, of each
lane's point in ONE launch, every one written out as (16, n, *batch). Its
caller is the fixed-base table build (`cuda_fixed_base.build_tables`),
which needs 255 doubles of each of 33-129 generators: one launch where a
double per launch took 255. The chain is serial — [2^(t+1)] P needs
[2^t] P — so one thread per lane keeps the point in registers for all n
doubles; on the build's few lanes its time is the latency of 7 n dependent
modular multiplies, nowhere near the card's rates. `pt_double` — the TPU
kernel's function, one double per lane — is the same kernel at n = 1. Both
count their launches under "pt_double".

`affine_rows`: the table build's affine step, the (x, y) of M rows of NE
Jacobian points, by Montgomery's trick along each row: one thread per row
multiplies the row's Z up, inverts the product once and walks back down
for each entry's Z^-1, in registers. It takes the place of the
reference's inversion of every entry there (`to_affine`, K2
`pallas_msm.pow_const_flat`). Its plain version runs the same trick as a
product tree in eager PyTorch: one `fp_inv` of the M roots and about
three limb multiplies per entry, where an inversion per entry would take
about 270. Affine values are canonical and unique, so the two agree limb
for limb whatever the order of their multiplies.

Kernel and plain version apply the same formulas and the same select
order, so they agree in (X, Y, Z) limb for limb, not only as points.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import field as f

LAUNCHES = {"pt_add": 0, "pt_double": 0, "affine_rows": 0}
PLAIN_CALLS = {"pt_add": 0, "pt_double": 0, "affine_rows": 0}

_VP = _build.VP


def flat_i32(t: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast an int64 limb tensor on the card to `shape`, narrow it to
    int32 and flatten the batch axes: (16, *shape[1:]) -> contiguous (16, B)."""
    _check_operand(t)
    return t.expand(shape).reshape(shape[0], -1).to(torch.int32).contiguous()


def _check_operand(t: torch.Tensor) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"limb tensors are int64, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError("all operands of a kernel must lie on the CUDA device")


def lane_strides(shape, strides):
    """(limb stride, lane stride) such that element i of lane b of a
    (16, *batch) tensor with these sizes and strides (in elements) lies at
    i * limb stride + b * lane stride, b the row-major index over the batch
    axes; None where the batch axes do not fold into one strided axis. A
    broadcast (stride 0) over every batch axis gives lane stride 0."""
    lane, extent = None, 1
    for size, stride in reversed(list(zip(shape[1:], strides[1:]))):
        if size == 1:
            continue
        if lane is None:
            lane, extent = stride, size
        elif stride != lane * extent:
            return None
        else:
            extent *= size
    return strides[0], lane or 0


def lane_view(t: torch.Tensor, shape):
    """An int64 limb operand on the card as a kernel that takes strides
    reads it: (tensor, limb stride, lane stride) of t broadcast to `shape`.
    The tensor is t itself where its batch axes fold into one strided axis,
    else one contiguous int64 copy."""
    _check_operand(t)
    if t.shape == shape and t.is_contiguous():
        return t, math.prod(shape[1:]), 1
    v = t.expand(shape)
    st = lane_strides(v.shape, v.stride())
    if st is None:
        v = v.contiguous()
        st = lane_strides(v.shape, v.stride())
    return v, st[0], st[1]


# -- plain PyTorch versions ---------------------------------------------------


def _stacked(op, *pairs):
    """op over several independent pairs of equal-shaped operands in ONE
    call on their stack (axis 1): the plain versions' independent field
    operations share one set of eager ops. Each result is the one op(a, b)
    would give (every field op is lane-wise)."""
    out = op(torch.stack([a for a, _ in pairs], dim=1), torch.stack([b for _, b in pairs], dim=1))
    return [out[:, i] for i in range(len(pairs))]


def _double_formula(X, Y, Z):
    """dbl-2009-l (a = 0). Complete for the identity: Z3 = 2YZ vanishes.
    Independent operations run stacked (`_stacked`)."""
    A, Bb = _stacked(f.fp_mul, (X, X), (Y, Y))
    t, A2, Y2 = _stacked(f.fp_add, (X, Bb), (A, A), (Y, Y))
    C, T2 = _stacked(f.fp_mul, (Bb, Bb), (t, t))
    E = f.fp_add(A2, A)
    F, Z3 = _stacked(f.fp_mul, (E, E), (Y2, Z))
    u, C2 = f.fp_sub(T2, A), f.fp_add(C, C)
    v, C4 = f.fp_sub(u, C), f.fp_add(C2, C2)
    D, C8 = _stacked(f.fp_add, (v, v), (C4, C4))
    X3 = f.fp_sub(F, f.fp_add(D, D))
    Y3 = f.fp_sub(f.fp_mul(E, f.fp_sub(D, X3)), C8)
    return X3, Y3, Z3


def pt_double_plain(X, Y, Z):
    PLAIN_CALLS["pt_double"] += 1
    return _double_formula(X, Y, Z)


def pt_double_chain_plain(X, Y, Z, n: int):
    """The n successive doubles of (16, *batch) coordinates by the same
    formula -> three (16, n, *batch)."""
    PLAIN_CALLS["pt_double"] += 1
    outs, p = [], (X, Y, Z)
    for _ in range(n):
        p = _double_formula(*p)
        outs.append(p)
    return tuple(torch.stack([o[c] for o in outs], dim=1) for c in range(3))


def affine_rows_plain(X, Y, Z):
    """Affine (x, y) of Jacobian points with coords (16, M, NE), NE a power
    of two, zero on identity entries, by Montgomery's trick along the last
    axis: a product tree of the Z over each row's NE entries (identity
    entries count as Z = 1), ONE inversion of the M roots, and the tree
    walked back down for each entry's Z^-1."""
    PLAIN_CALLS["affine_rows"] += 1
    is_id = f.fp_is_zero(Z)
    one = torch.zeros_like(Z)
    one[0] = 1
    tree = [torch.where(is_id, one, Z)]
    while tree[-1].shape[-1] > 1:
        t = tree[-1]
        tree.append(f.fp_mul(t[..., 0::2], t[..., 1::2]))
    inv = f.fp_inv(tree[-1])  # (16, M, 1)
    for t in reversed(tree[:-1]):
        # the parent's inverse times a node's sibling is the node's inverse
        inv = torch.stack([f.fp_mul(inv, t[..., 1::2]), f.fp_mul(inv, t[..., 0::2])],
                          dim=-1).reshape(t.shape)
    zi2 = f.fp_sqr(inv)
    x = f.fp_mul(X, zi2)
    y = f.fp_mul(Y, f.fp_mul(zi2, inv))
    zero = torch.zeros_like(x)
    return torch.where(is_id, zero, x), torch.where(is_id, zero, y)


def pt_add_plain(px, py, pz, qx, qy, qz):
    """Complete masked Jacobian add (add-2007-bl shape): generic path plus
    lane-mask fixups for p == identity, q == identity, the doubling
    collision (H == 0, r == 0) and the inverse collision (H == 0, r != 0)."""
    PLAIN_CALLS["pt_add"] += 1
    shape = torch.broadcast_shapes(px.shape, qx.shape)
    px, py, pz, qx, qy, qz = (c.expand(shape) for c in (px, py, pz, qx, qy, qz))
    X3, Y3, Z3, H, r = _add_formula(px, py, pz, qx, qy, qz)

    h_zero = f.fp_is_zero(H)
    r_zero = f.fp_is_zero(r)
    p_id = f.fp_is_zero(pz)
    q_id = f.fp_is_zero(qz)
    neither = ~(p_id | q_id)

    def sel(mask, a, b):
        return tuple(torch.where(mask, x, y) for x, y in zip(a, b))

    out = (X3, Y3, Z3)
    collide = neither & h_zero & r_zero
    if bool(collide.any()):  # the double is selected only on such lanes
        out = sel(collide, _double_formula(px, py, pz), out)
    zero = torch.zeros_like(px)
    one = zero.clone()
    one[0] = 1
    out = sel(neither & h_zero & ~r_zero, (zero, one, zero), out)
    out = sel(q_id, (px, py, pz), out)
    out = sel(p_id, (qx, qy, qz), out)
    return out


def _add_formula(px, py, pz, qx, qy, qz):
    """add-2007-bl's generic formulas on operands of one shape ->
    (X3, Y3, Z3, H, r); independent operations run stacked (`_stacked`)."""
    Z1Z1, Z2Z2, PZQZ = _stacked(f.fp_mul, (pz, pz), (qz, qz), (pz, qz))
    U1, U2, T1, T2 = _stacked(f.fp_mul, (px, Z2Z2), (qx, Z1Z1), (qz, Z2Z2), (pz, Z1Z1))
    S1, S2 = _stacked(f.fp_mul, (py, T1), (qy, T2))
    H, r = _stacked(f.fp_sub, (U2, U1), (S2, S1))
    HH, rr = _stacked(f.fp_mul, (H, H), (r, r))
    HHH, V, Z3 = _stacked(f.fp_mul, (H, HH), (U1, HH), (PZQZ, H))
    X3 = f.fp_sub(f.fp_sub(rr, HHH), f.fp_add(V, V))
    RV, SH = _stacked(f.fp_mul, (r, f.fp_sub(V, X3)), (S1, HHH))
    return X3, f.fp_sub(RV, SH), Z3, H, r


def tree_sum_plain(x, y, z):
    """Pairwise complete-add reduction of axis 1 of (16, L, *batch)
    coordinates, in eager PyTorch on either device; an odd leftover rides
    along to the next level. The reduction inside the plain MSMs; NOT the
    plain version of the tree-sum kernel, which chains incomplete adds
    (`cuda_ladder.tree_sum_plain`)."""
    while x.shape[1] > 1:
        L = x.shape[1]
        half = L // 2
        s = pt_add_plain(
            x[:, :half], y[:, :half], z[:, :half],
            x[:, half : 2 * half], y[:, half : 2 * half], z[:, half : 2 * half],
        )
        if L % 2:
            s = tuple(torch.cat([a, b[:, 2 * half :]], dim=1) for a, b in zip(s, (x, y, z)))
        x, y, z = s
    return x[:, 0], y[:, 0], z[:, 0]


# -- wrappers --------------------------------------------------------------------


# K5a's launch: 4 threads per lane while 4 B stays within this many
# threads, 2 beyond. One thread per lane (the earlier launch) was slower at every
# batch swept, up to the table build's 200,704 lanes (PERF.md).
K5A_SPLIT_THREADS = 32768
K5A_BLOCK = 128  # threads per block


def pt_add_plan(B: int) -> tuple[int, int]:
    """(threads per lane, lanes per block) of K5a's launch over B lanes:
    4 while 4 B <= K5A_SPLIT_THREADS, else 2."""
    T = 4 if 4 * B <= K5A_SPLIT_THREADS else 2
    return T, K5A_BLOCK // T


def pt_add_launch(ins, shape, T: int, lpb: int):
    """Launch K5a with T threads per lane and lpb lanes per block on six
    int64 operands broadcast to `shape` -> three (16, *shape[1:]) int64."""
    views = [lane_view(c, shape) for c in ins]
    outs = torch.empty((3,) + tuple(shape), dtype=torch.int64, device=ins[0].device).unbind(0)
    B = math.prod(shape[1:])
    fn = _build.bind("curve", "bppp_pt_add",
                     [ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_VP)]
                     + [ctypes.c_int] * 3 + [_VP])
    ptrs = (_VP * 6)(*(v[0].data_ptr() for v in views))
    strides = (ctypes.c_longlong * 12)(*(x for v in views for x in v[1:]))
    optrs = (_VP * 3)(*(o.data_ptr() for o in outs))
    err = fn(ptrs, strides, optrs, B, T, lpb, _build.stream())
    LAUNCHES["pt_add"] += 1
    _build.check(err, "pt_add")
    return tuple(outs)


def pt_add(px, py, pz, qx, qy, qz):
    """Complete add of two Jacobian points, coordinates (16, *batch) int64
    (operands broadcast against each other) -> three (16, *batch) int64.
    One launch: the kernel reads the operands where they lie."""
    if not px.is_cuda:
        return pt_add_plain(px, py, pz, qx, qy, qz)
    shapes = (px.shape, py.shape, pz.shape, qx.shape, qy.shape, qz.shape)
    shape = px.shape if shapes.count(px.shape) == 6 else torch.broadcast_shapes(*shapes)
    if shape[0] != 16:
        raise ValueError(f"limb axis must have 16 entries, got shape {tuple(shape)}")
    return pt_add_launch((px, py, pz, qx, qy, qz), shape, *pt_add_plan(math.prod(shape[1:])))


def _double_chain_launch(X, Y, Z, n: int):
    """Launch the chain kernel: three (16, n, B) int64, B the flattened batch."""
    shape = X.shape
    if shape[0] != 16:
        raise ValueError(f"limb axis must have 16 entries, got shape {tuple(shape)}")
    ins = [flat_i32(c, shape) for c in (X, Y, Z)]
    B = ins[0].shape[1]
    outs = [torch.empty((16, n, B), dtype=torch.int32, device=X.device) for _ in range(3)]
    fn = _build.bind("curve", "bppp_pt_double_chain", [_VP] * 6 + [ctypes.c_int] * 2 + [_VP])
    err = fn(*(t.data_ptr() for t in ins + outs), n, B, _build.stream())
    LAUNCHES["pt_double"] += 1
    _build.check(err, "pt_double")
    return tuple(o.to(torch.int64) for o in outs)


def pt_double_chain(X, Y, Z, n: int):
    """[2^t] P for t = 1..n of a Jacobian point per lane: coordinates
    (16, *batch) int64 -> three (16, n, *batch) int64, double t at index
    t - 1 of axis 1."""
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"a chain has at least one double, got n = {n!r}")
    if not X.is_cuda:
        return pt_double_chain_plain(X, Y, Z, n)
    out_shape = (16, n) + tuple(X.shape[1:])
    return tuple(c.reshape(out_shape) for c in _double_chain_launch(X, Y, Z, n))


def pt_double(X, Y, Z):
    """Double of a Jacobian point, coordinates (16, *batch) int64: the
    chain kernel at n = 1."""
    if not X.is_cuda:
        return pt_double_plain(X, Y, Z)
    return tuple(c.reshape(X.shape) for c in _double_chain_launch(X, Y, Z, 1))


def affine_rows(X, Y, Z):
    """Affine (x, y) of M rows of NE Jacobian points: coordinates
    (16, M, NE) int64, NE a power of two -> two (16, M, NE) int64, zero on
    identity entries. One inversion per row."""
    if X.ndim != 3 or X.shape[0] != 16 or not X.shape == Y.shape == Z.shape:
        raise ValueError(f"coordinates must be (16, M, NE), got {tuple(X.shape)}")
    NE = X.shape[2]
    if NE & (NE - 1):
        raise ValueError(f"the entry axis must be a power of two, got {NE}")
    if not X.is_cuda:
        return affine_rows_plain(X, Y, Z)
    M = X.shape[1]
    # (16, NE, M): a warp's threads own adjacent rows
    ins = [flat_i32(c, X.shape).reshape(X.shape).transpose(1, 2).contiguous() for c in (X, Y, Z)]
    outs = [torch.empty((16, NE, M), dtype=torch.int32, device=X.device) for _ in range(2)]
    fn = _build.bind("curve", "bppp_affine_rows", [_VP] * 5 + [ctypes.c_int] * 2 + [_VP])
    err = fn(*(t.data_ptr() for t in ins + outs), NE, M, _build.stream())
    LAUNCHES["affine_rows"] += 1
    _build.check(err, "affine_rows")
    return tuple(o.to(torch.int64).transpose(1, 2) for o in outs)
