"""Vector/matrix helpers over F_n scalars and curve points, host oracle.

Mirrors the 13 generic helpers of src/ of the Rust reference: util.rs:7-155. The
Rust code is generic over `T: Mul<Scalar> + Add`; here we provide scalar
(`s_*`) and point (`p_*`) variants. Every `p_vector_mul` call is a naive
MSM in the reference (util.rs:46-60).

Padding semantics (util.rs:24-26): shorter operand extended with
T::default() — 0 for scalars, the identity for points.
"""

from __future__ import annotations

from .curve import IDENTITY, Point
from .field import N, fn_add, fn_inv, fn_mul, fn_sub


def reduce_vec(v: list) -> tuple[list, list]:
    """Even/odd split (util.rs:7-22) — NOT first/second half."""
    return v[0::2], v[1::2]


def vector_extend_s(v: list[int], n: int) -> list[int]:
    return [v[i] if i < len(v) else 0 for i in range(n)]


def vector_extend_p(v: list[Point], n: int) -> list[Point]:
    return [v[i] if i < len(v) else IDENTITY for i in range(n)]


# -- scalar vector ops --------------------------------------------------

def s_vector_mul(a: list[int], b: list[int]) -> int:
    m = max(len(a), len(b))
    a, b = vector_extend_s(a, m), vector_extend_s(b, m)
    acc = 0
    for x, y in zip(a, b):
        acc = fn_add(acc, fn_mul(x, y))
    return acc


def s_weight_vector_mul(a: list[int], b: list[int], weight: int) -> int:
    """sum_i a_i * b_i * weight^(i+1)  (util.rs:28-44)."""
    m = max(len(a), len(b))
    a, b = vector_extend_s(a, m), vector_extend_s(b, m)
    acc, exp = 0, 1
    for x, y in zip(a, b):
        exp = fn_mul(exp, weight)
        acc = fn_add(acc, fn_mul(x, fn_mul(y, exp)))
    return acc


def s_vector_add(a: list[int], b: list[int]) -> list[int]:
    m = max(len(a), len(b))
    a, b = vector_extend_s(a, m), vector_extend_s(b, m)
    return [fn_add(x, y) for x, y in zip(a, b)]


def s_vector_sub(a: list[int], b: list[int]) -> list[int]:
    m = max(len(a), len(b))
    a, b = vector_extend_s(a, m), vector_extend_s(b, m)
    return [fn_sub(x, y) for x, y in zip(a, b)]


def s_vector_mul_on_scalar(a: list[int], s: int) -> list[int]:
    return [fn_mul(x, s) for x in a]


def s_vector_hadamard(a: list[int], b: list[int]) -> list[int]:
    m = max(len(a), len(b))
    a, b = vector_extend_s(a, m), vector_extend_s(b, m)
    return [fn_mul(x, y) for x, y in zip(a, b)]


def s_vector_tensor_mul(a: list[int], b: list[int]) -> list[int]:
    """Kronecker: concat of a*b_j for each j (util.rs:111-116)."""
    out: list[int] = []
    for y in b:
        out.extend(fn_mul(x, y) for x in a)
    return out


def e_powers(v: int, n: int) -> list[int]:
    """[1, v, v^2, ..., v^(n-1)]  (util.rs:87-95)."""
    out, buf = [], 1
    for _ in range(n):
        out.append(buf)
        buf = fn_mul(buf, v)
    return out


def s_pow(s: int, n: int) -> int:
    return pow(s, n, N)


def s_minus(v: int) -> int:
    return (-v) % N


def diag_inv(x: int, n: int) -> list[list[int]]:
    """n x n matrix with diagonal x^-1, x^-2, ... (util.rs:118-132)."""
    xi = fn_inv(x)
    out = [[0] * n for _ in range(n)]
    val = 1
    for i in range(n):
        val = fn_mul(val, xi)
        out[i][i] = val
    return out


def s_vector_mul_on_matrix(a: list[int], m: list[list[int]]) -> list[int]:
    """Row vector x matrix (util.rs:134-142)."""
    cols = len(m[0])
    return [s_vector_mul(a, [row[j] for row in m]) for j in range(cols)]


def s_matrix_mul_on_vector(a: list[int], m: list[list[int]]) -> list[int]:
    return [s_vector_mul(a, row) for row in m]


# -- point vector ops ---------------------------------------------------

def p_vector_mul(points: list[Point], scalars: list[int]) -> Point:
    """MSM: sum_i scalars_i * points_i (naive)."""
    m = max(len(points), len(scalars))
    points = vector_extend_p(points, m)
    scalars = vector_extend_s(scalars, m)
    acc = IDENTITY
    for pt, s in zip(points, scalars):
        acc = acc.add(pt.mul(s))
    return acc


def p_weight_vector_mul(points: list[Point], scalars: list[int], weight: int) -> Point:
    m = max(len(points), len(scalars))
    points = vector_extend_p(points, m)
    scalars = vector_extend_s(scalars, m)
    acc, exp = IDENTITY, 1
    for pt, s in zip(points, scalars):
        exp = fn_mul(exp, weight)
        acc = acc.add(pt.mul(fn_mul(s, exp)))
    return acc


def p_vector_add(a: list[Point], b: list[Point]) -> list[Point]:
    m = max(len(a), len(b))
    a, b = vector_extend_p(a, m), vector_extend_p(b, m)
    return [x.add(y) for x, y in zip(a, b)]


def p_vector_mul_on_scalar(a: list[Point], s: int) -> list[Point]:
    return [x.mul(s) for x in a]
