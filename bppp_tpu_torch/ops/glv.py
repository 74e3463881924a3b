"""GLV endomorphism scalar decomposition for secp256k1 (PyTorch).

Counterpart of `bppp_tpu/ops/glv.py`. secp256k1 has an efficiently
computable endomorphism phi(x, y) = (beta*x, y) with phi(P) = [lambda]P
(beta^3 = 1 in F_p, lambda^3 = 1 in F_n). Splitting k = k1 + k2*lambda
with |k1|, |k2| <~ 2^128 turns a 256-bit shared-window MSM walk (64
windows, 256 doubles) into a 132-bit walk (33 windows, 132 doubles) over
per-point PAIRS (P, phi(P)) — and phi(P)'s window table is just beta *
(x-entries of P's table), so the kernel's tables do not grow.

Decomposition (standard lattice rounding, constants as in libsecp256k1):
    c1 = round(k * b2 / n),  c2 = round(k * -b1 / n)
computed exactly in fixed point as (k * G_i) >> 384 with
G_i = round(2^384 * b_i / n) (the +-1 rounding slack only shifts k1/k2
within their |.| < 2^129 budget; 33 windows cover 132 bits), then
    k2 = -(c1*b1 + c2*b2) mod n,   k1 = k - k2*lambda mod n.
Signs: a value in (n/2, n) is the negative -(n - v); the kernel negates
the selected table entry's y per lane instead.
"""

from __future__ import annotations

import torch

from . import field as f
from .field import N_INT

LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

_B1_ABS = 0xE4437ED6010E88286F547FA90ABFE4C3  # b1 = -_B1_ABS
_B2 = 0x3086D221A7D46BCDE86C90E49284EB15

_SHIFT = 384
_G1 = ((_B2 << _SHIFT) + N_INT // 2) // N_INT
_G2 = ((_B1_ABS << _SHIFT) + N_INT // 2) // N_INT

# windows of 4 bits covering the |k_i| < 2^129 magnitude budget (+ slack)
GLV_WINDOWS = 33

_G1_LIMBS = f.int_to_limbs(_G1)
_G2_LIMBS = f.int_to_limbs(_G2)
_B1_ABS_LIMBS = f.int_to_limbs(_B1_ABS)
_B2_LIMBS = f.int_to_limbs(_B2)
_LAMBDA_LIMBS = f.int_to_limbs(LAMBDA)
_HALF_N_LIMBS = [int(x) for x in f.int_to_limbs(N_INT // 2)[:, 0]]


def _mul_shift(k, g_limbs):
    """floor((k * g + 2^383) / 2^384) -> (16, *batch) limbs (< 2^128),
    the high 8 limbs zero."""
    wide = f._mul_wide_arr(k, f._const(g_limbs, k))  # (32, *b) lazy
    half = [0] * 32
    half[23] = 0x8000  # rounding: + 2^383
    top = f._carry_arr(wide + f._const(half, wide), 32)[24:32]
    return f._place(top, 0, 16)


def _gt_half_n(a):
    """a > floor(n/2) on canonical (16, *batch) limbs (lex compare)."""
    gt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for i in range(15, -1, -1):
        c = _HALF_N_LIMBS[i]
        gt = gt | (eq & (a[i] > c))
        eq = eq & (a[i] == c)
    return gt


def wnaf_digits(m, neg):
    """Signed-window recoding of a GLV magnitude half: m (16, *batch)
    canonical limbs < 2^131, neg (*batch,) bool (the half's overall GLV
    sign) -> (GLV_WINDOWS, *batch) int64 planes packing |digit| (low 4
    bits, 0..8) and the FINAL per-digit negate bit (bit 4 = window_sign
    XOR neg), window 0 (least significant) first.

    Recoding d_w' = d_w + carry; if d_w' > 8 the digit becomes d_w' - 16
    (negative) and carries 1 — digits lie in [-7, 8], so a per-point
    window table needs magnitudes 1..8 only. The final carry cannot
    escape: it would need m >= 8*16^(GLV_WINDOWS-1) = 2^131, and |halves|
    < 2^129 + rounding slack (see decompose)."""
    carry = torch.zeros(m.shape[1:], dtype=f.DTYPE, device=m.device)
    negu = neg.to(f.DTYPE)
    planes = []
    for w in range(GLV_WINDOWS):
        raw = (m[w // 4] >> (4 * (w % 4))) & 15
        d = raw + carry
        over = d > 8
        carry = over.to(f.DTYPE)
        mag = torch.where(over, 16 - d, d)
        planes.append(mag | ((carry ^ negu) << 4))
    return torch.stack(planes, dim=0)


def decompose(k):
    """k: canonical (16, *batch) F_n limbs ->
    (m1, neg1, m2, neg2): magnitudes (16, *batch) with only the low 9
    limbs nonzero, and boolean negate masks (*batch,), such that
    (-1)^neg1 * m1 + (-1)^neg2 * m2 * lambda == k (mod n)."""
    c1 = _mul_shift(k, _G1_LIMBS)
    c2 = _mul_shift(k, _G2_LIMBS)
    # k2 = -(c1*b1 + c2*b2) = c1*|b1| - c2*b2 (mod n)
    k2 = f.fn_sub(
        f.fn_mul(c1, f._const(_B1_ABS_LIMBS, k)),
        f.fn_mul(c2, f._const(_B2_LIMBS, k)),
    )
    k1 = f.fn_sub(k, f.fn_mul(k2, f._const(_LAMBDA_LIMBS, k)))
    neg1 = _gt_half_n(k1)
    neg2 = _gt_half_n(k2)
    m1 = torch.where(neg1, f.fn_neg(k1), k1)
    m2 = torch.where(neg2, f.fn_neg(k2), k2)
    return m1, neg1, m2, neg2


def wnaf_planes(k):
    """K4's digit input: k (16, D, B) canonical F_n limbs -> (33 * 2D, B)
    int64 signed-digit planes, plane index w * 2D + j with the halves of
    point i interleaved, j = 2i (k1), 2i + 1 (k2)."""
    D, B = k.shape[1:]
    m1, n1, m2, n2 = decompose(k)
    d = torch.stack([wnaf_digits(m1, n1), wnaf_digits(m2, n2)], dim=2)  # (W, D, 2, B)
    return d.reshape(GLV_WINDOWS * 2 * D, B)


def glv_halves(k):
    """K8's input: k (16, D, B) canonical F_n limbs -> (mags (2D, 16, B)
    int64 magnitudes, signs (2D, B) int64 0/1 negate masks), half
    j = 2i (k1), 2i + 1 (k2) of point i — the layout of
    `bppp_tpu/ops/curve.py::_msm_small_call`."""
    D, B = k.shape[1:]
    m1, n1, m2, n2 = decompose(k)
    mags = torch.stack([m1, m2], dim=2).reshape(16, 2 * D, B).movedim(1, 0).contiguous()
    signs = torch.stack([n1, n2], dim=1).reshape(2 * D, B).to(f.DTYPE)
    return mags, signs
