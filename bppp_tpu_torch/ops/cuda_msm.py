"""Whole-loop kernels: the fixed-window exponentiation (K2) and the three
shared-window small MSMs — GLV + signed digits (K4), GLV + unsigned digits
(K8) and plain unsigned windows (K9).

Counterpart of `bppp_tpu/ops/pallas_msm.py` (its `pow_const_flat`,
`msm_small_wnaf_flat`, `msm_small_glv_flat` and `msm_small_flat`; its
ladder and tree are in `ops/cuda_ladder.py`). `curve.msm` picks one of the
three small MSMs per call by the reference's switches
(`curve.small_msm_variant`). Wrappers take and return int64
limb tensors in the interchange layout. On a CUDA tensor a wrapper
launches its kernel on the current stream without synchronising (the
small MSMs' wrappers narrow to int32 storage first and widen the result);
on a CPU tensor — and only there — it runs the plain PyTorch version
below.

K2 `pow_const` — replaces `pallas_msm._pow_kernel`. x^e for a host-static
exponent: `fp_inv`, `fp_sqrt`, `fn_inv`. The exponent becomes a step list
on the host, once per exponent (`field.pow_chain`: libsecp256k1's addition
chains for p - 2 and (p+1)/4, a chain over n's leading ones and a sliding
window for n - 2, a sliding window of width 4 for any other e), which
one launch interprets: squares through the dedicated square, the list's
slots in the thread's local memory. Bound on an H100: operations (253-256
squares and 13-41 multiplies per lane for the three named exponents, 256
bytes moved). Unlike the other wrappers here it reads and writes the
int64 limbs as they lie (a limb and a lane stride, `cuda_curve.lane_view`):
no narrowing or widening pass, one launch per call.

K4 `msm_small_wnaf` — replaces `pallas_msm._msm_small_wnaf_kernel`.
sum_i [s_i] P_i over D <= 5 per-proof points, scalars arriving as GLV
halves recoded to signed 4-bit digit planes. Bound on an H100: operations
(132 doubles + 66 D + 7 D adds per lane). The 2D halves are independent
33-window walks, so a lane has several threads (`msm_small_wnaf_plan`:
2D, one half each, up to 4096 lanes; one thread per lane beyond, where the
card is full), joined with complete adds; the tables [1..8] P_i of a lane
sit in shared memory, built once and read by all its threads (a lane's
only thread keeps them in its own array). Adds inside the walks are
incomplete (a collision degrades to the identity, unreachable for
challenge scalars), the plain version uses complete adds: the two agree as
POINTS (affine coordinates, compressed bytes), not in (X, Y, Z).

K9 `msm_small` — replaces `pallas_msm._msm_small_kernel`, the small MSM
under `BPPP_GLV=0`. sum_i [k_i] P_i over D <= 3 points from the full
256-bit scalars, 64 unsigned 4-bit windows MSB-first. Bound on an H100:
operations (252 doubles + 64 D adds + 14 D table operations per lane). At
the paths' 1024 lanes what bounds it is the series one thread runs, so a
lane has D threads (`msm_small_plan`), one point each: the thread builds
its table [0..15] P_i in its own array (local memory, measured a little
faster than shared memory) and walks its 64 windows (4 doubles, at most
one add each); the D partials join with complete adds in shared memory.
The 252 doubles of a full scalar stay in every thread's series: K9 is the
no-GLV path, so it gains less from the split than K8. The split beat one
thread per lane at every batch swept on the card (up to 16384 lanes), so
K9 has no other launch.

K8 `msm_small_glv` — replaces `pallas_msm._msm_small_glv_kernel`, the
small MSM under `BPPP_WNAF=0` with GLV on: 33 windows over the 2D unsigned
GLV magnitude halves, odd halves taking phi(P) = (beta x, y), a per-lane
mask negating a half. Bound on an H100: operations (128 doubles + 66 D
adds + 14 D table operations, and one beta multiply per odd half, per
lane). A lane has 2D threads (`msm_small_glv_plan`), one half each, over
the tables [1..15] P_i in shared memory that the even half's thread
builds; since phi and negation are homomorphisms, a thread walks the plain
table and applies beta and the sign once, to its partial. Where the card
is full (`K8_SPLIT_THREADS`) one thread walks all 2D halves with one
accumulator, phi and the sign per entry, its tables in its own array.

K8 and K9 keep 16-entry tables (1,440 bytes of shared memory per point and
lane for K8, 1,536 bytes of local memory per K9 thread), so they take at
most `DMAX_U4` = 3 points per call, as the reference's kernels do, where
K4's 8-entry tables take `DMAX` = 5; three points of 21 lanes and their
join already fill 97 KB of a K8 block. As for K4, their adds are
incomplete and they agree with their plain versions as points.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import cuda_curve
from . import field as f
from .cuda_curve import flat_i32
from .glv import BETA, GLV_WINDOWS

_VP = _build.VP

LAUNCHES = {"pow_const": 0, "msm_small_wnaf": 0, "msm_small_glv": 0, "msm_small": 0}
PLAIN_CALLS = {"pow_const": 0, "msm_small_wnaf": 0, "msm_small_glv": 0, "msm_small": 0}

# points per kernel call, bounded by each lane's tables:
DMAX = 5  # K4, tables [1..8] P_i: D * 768 bytes
DMAX_U4 = 3  # K8 and K9, 16-entry tables: D * 1440 or 1536 bytes


# -- K2 --------------------------------------------------------------------------


def pow_const_plain(x, e: int, kind: str):
    PLAIN_CALLS["pow_const"] += 1
    return f._pow_const(x, e, f.fp_mul if kind == "p" else f.fn_mul)


_POW_STEPS: dict = {}


def _packed_steps(chain):
    """The step list as the kernel takes it: one word per step, dst | src
    << 8 | mul << 16 | nsqr << 24, mul 0xFF for none."""
    words = _POW_STEPS.get(chain)
    if words is None:
        packed = [d | (s << 8) | ((m & 0xFF) << 16) | (n << 24) for d, s, n, m in chain.steps]
        words = _POW_STEPS[chain] = (ctypes.c_uint32 * max(1, len(packed)))(*packed)
    return words


def pow_const(x, e: int, kind: str):
    """x^e mod p (kind "p") or mod n (kind "n"); x (16, *batch) int64
    canonical limbs, e a positive host int below 2^256. 0 -> 0."""
    if kind not in ("p", "n"):
        raise ValueError(f"kind must be 'p' or 'n', got {kind!r}")
    if not (0 < e < (1 << 256)):
        raise ValueError("exponent out of range")
    if not x.is_cuda:
        return pow_const_plain(x, e, kind)
    shape = x.shape
    if shape[0] != 16:
        raise ValueError(f"limb axis must have 16 entries, got shape {tuple(shape)}")
    chain = f.pow_chain(e)
    xin, limb_stride, lane_stride = cuda_curve.lane_view(x, shape)
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    fn = _build.bind(
        "pow", "bppp_pow_const",
        [_VP, ctypes.c_longlong, ctypes.c_longlong, _VP, ctypes.c_int,
         ctypes.POINTER(ctypes.c_uint32)] + [ctypes.c_int] * 4 + [_VP],
    )
    err = fn(xin.data_ptr(), limb_stride, lane_stride, out.data_ptr(), math.prod(shape[1:]),
             _packed_steps(chain), len(chain.steps), chain.result, chain.slots,
             int(kind == "p"), _build.stream())
    LAUNCHES["pow_const"] += 1
    _build.check(err, "pow_const")
    return out


# -- K4 --------------------------------------------------------------------------


def _check_points(px, py, pz, dmax: int, what: str):
    D, L16, B = px.shape
    if L16 != 16 or py.shape != px.shape or pz.shape != px.shape:
        raise ValueError("points must be three (D, 16, B) tensors")
    if not 1 <= D <= dmax:
        raise ValueError(f"{what} takes 1..{dmax} points per call, got {D}")
    return D, B


def _check_msm_args(px, py, pz, dig):
    D, B = _check_points(px, py, pz, DMAX, "msm_small_wnaf")
    if dig.shape != (GLV_WINDOWS * 2 * D, B):
        raise ValueError(
            f"digit planes must be ({GLV_WINDOWS * 2 * D}, {B}), got {tuple(dig.shape)}"
        )
    return D, B


def _check_k9_args(px, py, pz, k):
    D, B = _check_points(px, py, pz, DMAX_U4, "msm_small")
    if k.shape != (D, 16, B):
        raise ValueError(f"msm_small: scalars must be ({D}, 16, {B}), got {tuple(k.shape)}")
    return D, B


def _check_k8_args(px, py, pz, mags, signs):
    D, B = _check_points(px, py, pz, DMAX_U4, "msm_small_glv")
    if mags.shape != (2 * D, 16, B):
        raise ValueError(
            f"msm_small_glv: magnitudes must be ({2 * D}, 16, {B}), got {tuple(mags.shape)}")
    if signs.shape != (2 * D, B):
        raise ValueError(
            f"msm_small_glv: negate masks must be ({2 * D}, {B}), got {tuple(signs.shape)}")
    return D, B


def _tables_plain(px, py, pz, n: int):
    """Entry e = [e] P_i for e < n, entry 0 the identity (0, 1, 0), by
    complete adds: three (n, 16, D, B) coordinate tables."""
    P = tuple(c.movedim(0, 1) for c in (px, py, pz))  # (16, D, B)
    ents = [P]
    for _ in range(n - 2):
        ents.append(cuda_curve.pt_add_plain(*ents[-1], *P))
    zero = torch.zeros_like(P[0])
    one = zero.clone()
    one[0] = 1
    return [torch.stack([i] + [e[c] for e in ents], dim=0)
            for c, i in enumerate((zero, one, zero))]


def _select_plain(tab, digit, point):
    """tab[digit[j]] of point point[j], for every j: digit (M, B) -> three
    (16, M, B)."""
    M, B = digit.shape
    idx = digit[None, None].expand(1, 16, M, B)
    return tuple(torch.gather(c[:, :, point], 0, idx)[0] for c in tab)


def _walk_plain(n_windows: int, entries, like):
    """MSB-first shared walk with complete adds: 4 doubles per window (none
    before the first), then the points `entries(w)` selects for window w —
    three (16, M, B) — summed and added. `like`: a (16, B) tensor of the
    lanes' shape and device."""
    zero = torch.zeros_like(like)
    one = zero.clone()
    one[0] = 1
    acc = (zero, one, zero)
    for w in range(n_windows - 1, -1, -1):
        if w != n_windows - 1:
            for _ in range(4):
                acc = cuda_curve.pt_double_plain(*acc)
        acc = cuda_curve.pt_add_plain(*acc, *cuda_curve.tree_sum_plain(*entries(w)))
    return acc


def _beta_neg(q, odd, neg):
    """x times beta where `odd`, y negated where `neg`: (M,) and (M, B) bool."""
    qx, qy, qz = q
    beta = f._const(f.int_to_limbs(BETA), qx)
    qx = torch.where(odd[:, None], f.fp_mul(qx, beta), qx)
    qy = torch.where(neg, f.fp_neg(qy), qy)
    return qx, qy, qz


def msm_small_wnaf_plain(px, py, pz, dig):
    """The same walk in eager PyTorch, with complete adds: tables
    [1..8] P_i, then per window (MSB first) 4 doubles and the 2D selected
    entries — x times beta for the odd (endomorphism) halves, y negated
    where the plane's bit 4 is set, magnitude 0 the identity."""
    PLAIN_CALLS["msm_small_wnaf"] += 1
    D, B = _check_msm_args(px, py, pz, dig)
    tab = _tables_plain(px, py, pz, 9)
    planes = dig.reshape(GLV_WINDOWS, 2 * D, B)
    point = torch.arange(2 * D, device=px.device) // 2
    odd = torch.arange(2 * D, device=px.device) % 2 == 1

    def entries(w):
        q = _select_plain(tab, planes[w] & 15, point)
        return _beta_neg(q, odd, (planes[w] >> 4) != 0)

    return _walk_plain(GLV_WINDOWS, entries, px[0])


def msm_small_plain(px, py, pz, k):
    """K9's walk in eager PyTorch, with complete adds: tables [0..15] P_i,
    then 64 windows MSB-first, 4 doubles and the D entries the scalars'
    digits select."""
    PLAIN_CALLS["msm_small"] += 1
    D, _ = _check_k9_args(px, py, pz, k)
    tab = _tables_plain(px, py, pz, 16)
    point = torch.arange(D, device=px.device)
    kk = k.movedim(0, 1)  # (16, D, B)

    def entries(w):
        return _select_plain(tab, (kk[w // 4] >> (4 * (w % 4))) & 15, point)

    return _walk_plain(64, entries, px[0])


def msm_small_glv_plain(px, py, pz, mags, signs):
    """K8's walk in eager PyTorch, with complete adds: tables [0..15] P_i,
    then 33 windows MSB-first, 4 doubles and the 2D entries the magnitude
    halves' digits select — x times beta for the odd halves, y negated
    where the half's mask is set."""
    PLAIN_CALLS["msm_small_glv"] += 1
    D, _ = _check_k8_args(px, py, pz, mags, signs)
    tab = _tables_plain(px, py, pz, 16)
    point = torch.arange(2 * D, device=px.device) // 2
    odd = torch.arange(2 * D, device=px.device) % 2 == 1
    mm = mags.movedim(0, 1)  # (16, 2D, B)

    def entries(w):
        q = _select_plain(tab, (mm[w // 4] >> (4 * (w % 4))) & 15, point)
        return _beta_neg(q, odd, signs != 0)

    return _walk_plain(GLV_WINDOWS, entries, px[0])


K4_BLOCK = 128  # threads per block at most (the kernel's MAX_THREADS)
K4_SMEM = 72 * 1024  # shared bytes per block at most
# Above this many lanes one thread per lane: the split's extra doubles and
# shared tables then cost more than its shorter series saves. The sweep of
# both launches on the H100 (`tools/compare_designs.py`, PERF.md): the split
# wins at every D up to 4096 lanes, the lane walk at 16384, and at 8192 the
# lane walk at D >= 3 (by 12-30 %), the split at D <= 2 (by 7-10 %). The
# paths run 1024 and 16384 lanes.
K4_LANE_WALK_ABOVE = 4096
K4_LANE_BLOCK = 64  # lanes per block of the one-thread-per-lane launch


def k4_smem_bytes(D: int, lpb: int) -> int:
    """Shared memory of a block of the split launch: the lanes' tables
    [1..8] P_i (96 bytes an entry) and the join's partials of 2D slots
    (`csrc/join.cuh`)."""
    return 4 * lpb * (D * 8 * 24 + 24 * D)


def msm_small_wnaf_plan(D: int, B: int):
    """(threads per lane, lanes per block) of a K4 launch: 2D (one GLV half
    each) up to K4_LANE_WALK_ABOVE lanes, as many lanes per block as
    K4_BLOCK threads hold; 1 beyond."""
    if B > K4_LANE_WALK_ABOVE:
        return 1, K4_LANE_BLOCK
    return 2 * D, K4_BLOCK // (2 * D)


def msm_small_wnaf(px, py, pz, dig):
    """px, py, pz: (D, 16, B) int64 Jacobian coordinates of D <= 5 points
    per lane; dig: (33 * 2D, B) int64 packed signed-digit planes in
    `glv.wnaf_digits` order (plane index w * 2D + j, window 0 least
    significant, halves interleaved k1, k2 per point). -> three (16, B)
    int64: the Jacobian sum per lane."""
    if not px.is_cuda:
        return msm_small_wnaf_plain(px, py, pz, dig)
    D, B = _check_msm_args(px, py, pz, dig)
    nthr, lpb = msm_small_wnaf_plan(D, B)
    ins = [flat_i32(c, c.shape) for c in (px, py, pz)]
    planes = flat_i32(dig, dig.shape)
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind(
        "msm_small", "bppp_msm_small_wnaf", [_VP] * 7 + [ctypes.c_int] * 4 + [_VP]
    )
    err = fn(*(t.data_ptr() for t in ins), planes.data_ptr(),
             *(t.data_ptr() for t in outs), D, B, nthr, lpb, _build.stream())
    LAUNCHES["msm_small_wnaf"] += 1
    _build.check(err, "msm_small_wnaf")
    return tuple(o.to(torch.int64) for o in outs)


# -- K9, K8 ----------------------------------------------------------------------

U4_BLOCK = 128  # threads per block at most (the kernel's MAX_THREADS)
U4_SMEM = 227 * 1024  # shared bytes a block may opt into on an H100
U4_LANE_BLOCK = 64  # lanes per block of the one-thread-per-lane launches
# K8's split runs while its threads (2D per lane x lanes) stay at most
# this; beyond, where the card is full, its extra doubles cost more than its
# shorter series saves and one thread per lane runs. The sweep of both
# launches on the H100 (`tools/compare_designs.py`, PERF.md) crosses over
# at one thread count for every D: the split won at 49,152 (D = 3 at 8192
# lanes), the lane walk at 65,536 (D = 2 at 16384, by 4 %) and 98,304 (D = 3
# at 16384). K9's split won at every swept lane count and D, so K9 has no
# lane walk. The paths run 1024 lanes.
K8_SPLIT_THREADS = 49152


def k8_smem_bytes(D: int, lpb: int) -> int:
    """Shared memory of a block of K8's split launch: the lanes' tables
    [1..15] P_i (96 bytes an entry) and the join's partials of 2D slots
    (`csrc/join.cuh`)."""
    return 4 * lpb * (D * 15 * 24 + 24 * D)


def k9_smem_bytes(D: int, lpb: int) -> int:
    """Shared memory of a block of K9's split launch: the join's partials of
    D slots (each thread keeps its table in its own array)."""
    return 4 * lpb * 24 * (D // 2)


def msm_small_plan(D: int, B: int):
    """(threads per lane, lanes per block) of a K9 launch: D (one point
    each), as many lanes per block as U4_BLOCK threads hold, at any B."""
    return D, U4_BLOCK // D


def msm_small_glv_plan(D: int, B: int):
    """(threads per lane, lanes per block) of a K8 launch: 2D (one GLV
    half each) while 2D x B <= K8_SPLIT_THREADS, as many lanes per block
    as U4_BLOCK threads hold; 1 beyond."""
    if 2 * D * B > K8_SPLIT_THREADS:
        return 1, U4_LANE_BLOCK
    return 2 * D, U4_BLOCK // (2 * D)


def msm_small(px, py, pz, k):
    """px, py, pz: (D, 16, B) int64 Jacobian coordinates of D <= 3 points
    per lane; k: (D, 16, B) int64 canonical F_n limbs of their scalars.
    -> three (16, B) int64: the Jacobian sum per lane."""
    if not px.is_cuda:
        return msm_small_plain(px, py, pz, k)
    D, B = _check_k9_args(px, py, pz, k)
    nthr, lpb = msm_small_plan(D, B)
    ins = [flat_i32(c, c.shape) for c in (px, py, pz, k)]
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind("msm_small_u4", "bppp_msm_small", [_VP] * 7 + [ctypes.c_int] * 4 + [_VP])
    err = fn(*(t.data_ptr() for t in ins + outs), D, B, nthr, lpb, _build.stream())
    LAUNCHES["msm_small"] += 1
    _build.check(err, "msm_small")
    return tuple(o.to(torch.int64) for o in outs)


def msm_small_glv(px, py, pz, mags, signs):
    """px, py, pz: (D, 16, B) int64 Jacobian coordinates of D <= 3 points
    per lane; mags: (2D, 16, B) int64 GLV magnitude halves below 2^132,
    half j = 2i + (0 for k1, 1 for k2) of point i; signs: (2D, B) int64,
    nonzero where half j is negative (`glv.glv_halves` makes both).
    -> three (16, B) int64: the Jacobian sum per lane."""
    if not px.is_cuda:
        return msm_small_glv_plain(px, py, pz, mags, signs)
    D, B = _check_k8_args(px, py, pz, mags, signs)
    nthr, lpb = msm_small_glv_plan(D, B)
    ins = [flat_i32(c, c.shape) for c in (px, py, pz, mags, signs)]
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind("msm_small_u4", "bppp_msm_small_glv", [_VP] * 8 + [ctypes.c_int] * 4 + [_VP])
    err = fn(*(t.data_ptr() for t in ins + outs), D, B, nthr, lpb, _build.stream())
    LAUNCHES["msm_small_glv"] += 1
    _build.check(err, "msm_small_glv")
    return tuple(o.to(torch.int64) for o in outs)
