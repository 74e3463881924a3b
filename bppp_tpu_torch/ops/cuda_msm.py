"""Whole-loop kernels: the fixed-window exponentiation (K2) and the GLV +
signed-window small MSM (K4).

Counterpart of `bppp_tpu/ops/pallas_msm.py` (its `pow_const_flat` and
`msm_small_wnaf_flat`; its ladder and tree are in `ops/cuda_ladder.py`,
its two non-default small-MSM variants are not ported yet). Wrappers take and return int64
limb tensors in the interchange layout. On a CUDA tensor a wrapper
narrows to int32 storage, launches its kernel on the current stream and
widens the result, without synchronising; on a CPU tensor — and only
there — it runs the plain PyTorch version below.

K2 `pow_const` — replaces `pallas_msm._pow_kernel`. x^e for a host-static
exponent: `fp_inv`, `fp_sqrt`, `fn_inv`. Bound on an H100: operations
(14 + 5 * 64 modular multiplies per lane, 128 bytes moved). One launch
holds the whole ladder, the table lives in the thread's local memory and
is indexed directly, and the modulus is fixed at compile time.

K4 `msm_small_wnaf` — replaces `pallas_msm._msm_small_wnaf_kernel`.
sum_i [s_i] P_i over D <= 5 per-proof points, scalars arriving as GLV
halves recoded to signed 4-bit digit planes. Bound on an H100: operations
(132 doubles + 66 D + 7 D adds per lane). The whole 33-window walk runs
in one launch with the accumulator in registers; the per-lane tables
[1..8] P_i sit in local memory. Adds inside the kernel are incomplete
(a collision degrades to the identity, unreachable for challenge
scalars), the plain version uses complete adds: the two agree as POINTS
(affine coordinates, compressed bytes), not in (X, Y, Z).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import cuda_curve
from . import field as f
from .cuda_curve import flat_i32
from .glv import BETA, GLV_WINDOWS

_VP = _build.VP

LAUNCHES = {"pow_const": 0, "msm_small_wnaf": 0}
PLAIN_CALLS = {"pow_const": 0, "msm_small_wnaf": 0}

DMAX = 5  # points per kernel call: the table is D * 768 bytes of local memory


def _pow_digits(e: int) -> list[int]:
    """MSB-first 4-bit digits of e."""
    ndig = max(1, (e.bit_length() + 3) // 4)
    return [(e >> (4 * (ndig - 1 - i))) & 15 for i in range(ndig)]


# -- K2 --------------------------------------------------------------------------


def pow_const_plain(x, e: int, kind: str):
    PLAIN_CALLS["pow_const"] += 1
    return f._pow_const(x, e, f.fp_mul if kind == "p" else f.fn_mul)


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
    xin = flat_i32(x, shape)
    B = xin.shape[1]
    out = torch.empty((16, B), dtype=torch.int32, device=x.device)
    digits = _pow_digits(e)
    buf = (ctypes.c_uint8 * len(digits))(*digits)
    fn = _build.bind(
        "pow", "bppp_pow_const",
        [_VP, _VP, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, _VP],
    )
    err = fn(xin.data_ptr(), out.data_ptr(), B, buf, len(digits), int(kind == "p"),
             _build.stream())
    LAUNCHES["pow_const"] += 1
    _build.check(err, "pow_const")
    return out.to(torch.int64).reshape(shape)


# -- K4 --------------------------------------------------------------------------


def _check_msm_args(px, py, pz, dig):
    D, L16, B = px.shape
    if L16 != 16 or py.shape != px.shape or pz.shape != px.shape:
        raise ValueError("points must be three (D, 16, B) tensors")
    if not 1 <= D <= DMAX:
        raise ValueError(f"msm_small_wnaf takes 1..{DMAX} points per call, got {D}")
    if dig.shape != (GLV_WINDOWS * 2 * D, B):
        raise ValueError(
            f"digit planes must be ({GLV_WINDOWS * 2 * D}, {B}), got {tuple(dig.shape)}"
        )
    return D, B


def msm_small_wnaf_plain(px, py, pz, dig):
    """The same walk in eager PyTorch, with complete adds: tables
    [1..8] P_i, then per window (MSB first) 4 doubles and the 2D selected
    entries — x times beta for the odd (endomorphism) halves, y negated
    where the plane's bit 4 is set, magnitude 0 the identity."""
    PLAIN_CALLS["msm_small_wnaf"] += 1
    D, B = _check_msm_args(px, py, pz, dig)
    P = tuple(c.movedim(0, 1) for c in (px, py, pz))  # (16, D, B)
    ents = [P]
    for _ in range(7):
        ents.append(cuda_curve.pt_add_plain(*ents[-1], *P))
    zero = torch.zeros_like(P[0])
    one = zero.clone()
    one[0] = 1
    # entry 0 = identity, entries 1..8 = [d] P_i: (9, 16, D, B)
    tab = [torch.stack([i] + [e[c] for e in ents], dim=0)
           for c, i in enumerate((zero, one, zero))]
    beta = f._const(f.int_to_limbs(BETA), zero)
    planes = dig.reshape(GLV_WINDOWS, D, 2, B)
    acc = (zero[:, 0], one[:, 0], zero[:, 0])
    for w in range(GLV_WINDOWS - 1, -1, -1):
        if w != GLV_WINDOWS - 1:
            for _ in range(4):
                acc = cuda_curve.pt_double_plain(*acc)
        halves = []
        for half in range(2):
            plane = planes[w, :, half]  # (D, B)
            idx = (plane & 15)[None, None].expand(1, 16, D, B)
            qx, qy, qz = (torch.gather(c, 0, idx)[0] for c in tab)
            if half:
                qx = f.fp_mul(qx, beta)
            qy = torch.where((plane >> 4) != 0, f.fp_neg(qy), qy)
            halves.append((qx, qy, qz))
        qx, qy, qz = (torch.cat(pair, dim=1) for pair in zip(*halves))
        acc = cuda_curve.pt_add_plain(*acc, *cuda_curve.tree_sum_plain(qx, qy, qz))
    return acc


def msm_small_wnaf(px, py, pz, dig):
    """px, py, pz: (D, 16, B) int64 Jacobian coordinates of D <= 5 points
    per lane; dig: (33 * 2D, B) int64 packed signed-digit planes in
    `glv.wnaf_digits` order (plane index w * 2D + j, window 0 least
    significant, halves interleaved k1, k2 per point). -> three (16, B)
    int64: the Jacobian sum per lane."""
    if not px.is_cuda:
        return msm_small_wnaf_plain(px, py, pz, dig)
    D, B = _check_msm_args(px, py, pz, dig)
    ins = [flat_i32(c, c.shape) for c in (px, py, pz)]
    planes = flat_i32(dig, dig.shape)
    outs = [torch.empty((16, B), dtype=torch.int32, device=px.device) for _ in range(3)]
    fn = _build.bind(
        "msm_small", "bppp_msm_small_wnaf", [_VP] * 7 + [ctypes.c_int, ctypes.c_int, _VP]
    )
    err = fn(*(t.data_ptr() for t in ins), planes.data_ptr(),
             *(t.data_ptr() for t in outs), D, B, _build.stream())
    LAUNCHES["msm_small_wnaf"] += 1
    _build.check(err, "msm_small_wnaf")
    return tuple(o.to(torch.int64) for o in outs)
