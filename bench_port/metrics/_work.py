"""The work of each hand-written kernel, counted by the function it
computes and its inputs, never by the design that runs it.

The yardstick of the `hand_written_roofline.*` metrics. A launch's bound is
the larger of its bytes over the card's memory bandwidth and its 32-bit
integer operations over the card's integer rate:

- NVIDIA H100 SXM data sheet: 3.35e12 B/s of HBM3. The data sheet gives
  no integer rate; 33.5e12 int32 op/s is assumed, half of the 67 TFLOP/s
  of float32 outside the tensor cores (an SM has half as many int32 lanes
  as float32 lanes). A multiply-add counts as two operations.
- A field element is 32 bytes, a Jacobian point 96, an affine point 64,
  a Keccak state 200: each input read once and each output written once,
  at these widths, whatever the storage. A table is read once per launch.
- Arithmetic mod p or n on 256-bit values: a multiply is the 8 x 8
  schoolbook product of 32-bit limbs, 64 multiply-adds (128 operations),
  a square its 36 distinct products (72 operations); the reduction is not
  counted, nor are carries, so a design of these functions does at least
  this much with these inputs.
- Group operations on secp256k1 (a = 0), in multiplies M and squares S:
  a complete add 11M + 5S, a mixed add (affine second operand) 7M + 4S, a
  double 2M + 5S. An exponentiation x^e takes at least bitlen(e) - 1
  squares (an addition chain for e is at least that long); an inversion
  counts as x^(p-2).
- A scalar multiplication by a 256-bit scalar splits into two 128-bit
  halves (the curve's endomorphism): 127 doubles shared by all points of
  a lane and, per half, 128 / 6 adds (signed windows of width 5).
- A sum of L points per lane takes L - 1 complete adds.
- A fixed-base MSM of F generators per lane: F scalars in and one point
  out per lane, and the F generators read once. Its group operations are
  counted at a window width frozen in this yardstick, W = 8 bits (the
  width the port's tables had when the yardstick was set): ceil(256 / W)
  precomputed affine entries per generator, summed with mixed adds. The
  count never reads the tables the program built, so a program that builds
  them at another width is measured against the same work.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

FE = 32  # bytes of a field element or scalar
PT = 3 * FE  # a Jacobian point
AFF = 2 * FE
M_OPS = 2 * 64
S_OPS = 2 * 36
ADD = 11 * M_OPS + 5 * S_OPS
MIXED = 7 * M_OPS + 4 * S_OPS
DBL = 2 * M_OPS + 5 * S_OPS
P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
INV = (P_INT - 2).bit_length() - 1  # squares of an inversion
FIXED_W = 8  # the fixed-base MSM's window width, frozen (see above)
# Keccak-f[1600]: per round 130 64-bit operations (theta 55, rho 24, chi
# 50, iota 1), each two 32-bit operations; 24 rounds
KECCAK_OPS = 24 * 130 * 2


def _lanes(shape, skip: int) -> int:
    return math.prod(shape[skip:])


def _scalar_mul_ops(points_per_lane: int) -> int:
    return 127 * DBL + points_per_lane * 2 * math.ceil(128 / 6) * ADD


def f1600(state):
    B = _lanes(state.shape, 1)
    return KECCAK_OPS * B, 2 * 200 * B


def pow_const(x, e, kind):
    B = _lanes(x.shape, 1)
    return (int(e).bit_length() - 1) * S_OPS * B, 2 * FE * B


def _small_msm(px, *_):
    D, B = px.shape[0], _lanes(px.shape, 2)
    return _scalar_mul_ops(D) * B, (D * (PT + FE) + PT) * B


msm_small_wnaf = msm_small_glv = msm_small = _small_msm


def fixed_msm(tab, scalars):
    F, B = scalars.shape[1], _lanes(scalars.shape, 2)
    nw = math.ceil(256 / FIXED_W)
    return (F * nw - 1) * MIXED * B, (F * FE + PT) * B + F * AFF


def pt_add(*ops):
    B = max(_lanes(c.shape, 1) for c in ops)
    inputs = sum(_lanes(c.shape, 1) for c in ops) * FE
    return ADD * B, inputs + PT * B


def pt_double_chain(X, Y, Z, n):
    B = _lanes(X.shape, 1)
    return n * DBL * B, PT * B + n * PT * B


def pt_double(X, Y, Z):
    return pt_double_chain(X, Y, Z, 1)


def affine_rows(X, Y, Z):
    M, NE = X.shape[1], X.shape[2]
    # one inversion per row, 3 multiplies per entry to share it, then
    # z^-2 (S), z^-3, x z^-2, y z^-3 (3M) per entry
    ops = M * (INV * S_OPS + NE * (6 * M_OPS + S_OPS))
    return ops, M * NE * (PT + AFF)


def scalar_mul(px, py, pz, k):
    B = max(_lanes(px.shape, 1), _lanes(k.shape, 1))
    return _scalar_mul_ops(1) * B, (_lanes(px.shape, 1) * PT + _lanes(k.shape, 1) * FE + PT * B)


def tree_sum(x, y, z):
    L, B = x.shape[1], _lanes(x.shape, 2)
    return (L - 1) * ADD * B, (L * PT + PT) * B


WRAPPERS = {
    "cuda_keccak": ("f1600",),
    "cuda_msm": ("pow_const", "msm_small_wnaf", "msm_small_glv", "msm_small"),
    "cuda_fixed_base": ("fixed_msm",),
    "cuda_curve": ("pt_add", "pt_double_chain", "pt_double", "affine_rows"),
    "cuda_ladder": ("scalar_mul", "tree_sum"),
}


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
