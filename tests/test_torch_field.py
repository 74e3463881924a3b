"""The port's limb field arithmetic (bppp_tpu_torch.ops.field) against the
JAX package (bppp_tpu.ops.field) and Python ints: the same numpy inputs go
through both, and every comparison is exact (tolerance 0) — limbs, bytes
and masks are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import field as jf
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle.field import N, P

rng = np.random.default_rng(20261016)


def rand_ints(n, m):
    return [int.from_bytes(rng.bytes(40), "big") % m for _ in range(n)]


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


FP_EDGE = [0, 1, P - 1, N - 1, 2, P - 2]
FN_EDGE = [0, 1, N - 1, 2, N - 2, (1 << 128) + 5]
WIDE_EDGE = [0, 1, P - 1, N - 1, P, N, 2**256 - 1]


def operands(edge, m):
    xs = edge + rand_ints(6, m)
    ys = list(reversed(edge)) + rand_ints(6, m)
    return xs, ys


BINARY = {
    "fp_add": (P, lambda a, b: (a + b) % P),
    "fp_sub": (P, lambda a, b: (a - b) % P),
    "fp_mul": (P, lambda a, b: a * b % P),
    "fn_add": (N, lambda a, b: (a + b) % N),
    "fn_sub": (N, lambda a, b: (a - b) % N),
    "fn_mul": (N, lambda a, b: a * b % N),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op(name):
    m, ref = BINARY[name]
    xs, ys = operands(FP_EDGE if m == P else FN_EDGE, m)
    a, b = tf.ints_to_limbs(xs), tf.ints_to_limbs(ys)
    got = getattr(tf, name)(T(a), T(b))
    assert tf.limbs_to_ints(got) == [ref(x, y) for x, y in zip(xs, ys)]
    assert same(got, getattr(jf, name)(J(a), J(b)))


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_broadcasts(name):
    m, ref = BINARY[name]
    xs, y = rand_ints(6, m), rand_ints(1, m)[0]
    a = tf.ints_to_limbs(xs).reshape(16, 2, 3)
    b = tf.int_to_limbs(y).reshape(16, 1, 1)
    got = getattr(tf, name)(T(a), T(b))
    assert got.shape == (16, 2, 3)
    assert tf.limbs_to_ints(got.reshape(16, 6)) == [ref(x, y) for x in xs]
    assert same(got, getattr(jf, name)(J(a), J(b)))


UNARY = {
    "fp_neg": (P, lambda a: -a % P),
    "fp_sqr": (P, lambda a: a * a % P),
    "fn_neg": (N, lambda a: -a % N),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op(name):
    m, ref = UNARY[name]
    xs, _ = operands(FP_EDGE if m == P else FN_EDGE, m)
    a = tf.ints_to_limbs(xs)
    got = getattr(tf, name)(T(a))
    assert tf.limbs_to_ints(got) == [ref(x) for x in xs]
    assert same(got, getattr(jf, name)(J(a)))


@pytest.mark.parametrize("name", ["fp_is_zero", "fn_is_zero"])
def test_is_zero(name):
    xs = [0, 1, 1 << 240, 0, N - 1]
    a = tf.ints_to_limbs(xs)
    got = getattr(tf, name)(T(a))
    assert got.tolist() == [x == 0 for x in xs]
    assert np.array_equal(got.numpy(), np.asarray(getattr(jf, name)(J(a))))


def test_host_converters():
    xs = WIDE_EDGE + rand_ints(3, 1 << 256)
    a = tf.ints_to_limbs(xs)
    assert a.dtype == np.int64 and a.shape == (16, len(xs))
    assert np.array_equal(a, np.asarray(jf.ints_to_limbs(xs)).astype(np.int64))
    assert tf.limbs_to_ints(a) == xs
    assert tf.limbs_to_ints(T(a)) == xs
    for x in xs[:4]:
        col = tf.int_to_limbs(x)
        assert np.array_equal(col, jf.int_to_limbs(x).astype(np.int64))
        assert tf.limbs_to_int(col) == x and tf.limbs_to_int(T(col)[:, 0]) == x
    assert tf.int_to_limbs(5, 9).shape == (9, 1)


def test_fn_sum():
    xs = rand_ints(15, N) + [N - 1] * 5
    a = tf.ints_to_limbs(xs).reshape(16, 10, 2).transpose(1, 0, 2)  # (L, 16, B)
    got = tf.fn_sum(T(a))
    want = [sum(xs[2 * i + b] for i in range(10)) % N for b in range(2)]
    assert tf.limbs_to_ints(got) == want
    assert same(got, jf.fn_sum(J(a)))


@pytest.mark.parametrize("out_len", [17, 18, 32])
def test_carry(out_len):
    lazy = rng.integers(0, 1 << 31, size=(16, 7), dtype=np.int64)
    lazy[:, 0] = 0xFFFF  # a full propagate chain
    lazy[0, 0] = 0x1FFFF
    got = tf._carry(T(lazy), out_len)
    assert same(got, jf._carry(J(lazy), out_len))
    val = [sum(int(lazy[i, j]) << (16 * i) for i in range(16)) for j in range(7)]
    assert tf.limbs_to_ints(got) == [v % (1 << (16 * out_len)) for v in val]


@pytest.mark.parametrize("kind", ["p", "n"])
def test_fold_of_wide_products(kind):
    """The lazy 32-column product of pre-reduction edge values (p, n,
    2^256 - 1 among them) folds to the canonical residue."""
    m = P if kind == "p" else N
    xs = WIDE_EDGE + rand_ints(3, 1 << 256)
    ys = list(reversed(WIDE_EDGE)) + rand_ints(3, 1 << 256)
    a, b = tf.ints_to_limbs(xs), tf.ints_to_limbs(ys)
    wide_t = tf._mul_wide_arr(T(a), T(b))
    wide_j = jf._mul_wide_arr(J(a), J(b))
    assert same(wide_t, wide_j)
    fold_t = getattr(tf, f"_fold_{kind}")(wide_t)
    assert tf.limbs_to_ints(fold_t) == [x * y % m for x, y in zip(xs, ys)]
    assert same(fold_t, getattr(jf, f"_fold_{kind}")(wide_j))


@pytest.mark.parametrize("m", [P, N], ids=["p", "n"])
def test_cond_sub_and_lt_const(m):
    xs = [0, 1, m - 1, m, m + 1, 2**256 - 1] + rand_ints(4, 1 << 256)
    a = tf.ints_to_limbs(xs)
    got = tf._cond_sub(T(a), tf.int_to_limbs(m))
    assert tf.limbs_to_ints(got) == [x - m if x >= m else x for x in xs]
    assert same(got, jf._cond_sub(J(a), jf.int_to_limbs(m)))
    lt = tf.limbs_lt_const(T(a), m)
    assert lt.tolist() == [x < m for x in xs]
    assert np.array_equal(lt.numpy(), np.asarray(jf.limbs_lt_const(J(a), m)))


def test_select():
    a, b = tf.ints_to_limbs(rand_ints(4, P)), tf.ints_to_limbs(rand_ints(4, P))
    mask = np.array([True, False, False, True])
    got = tf.select(torch.from_numpy(mask), T(a), T(b))
    assert same(got, jf.select(jnp.asarray(mask), J(a), J(b)))
    assert np.array_equal(got.numpy(), np.where(mask, a, b))


def test_byte_conversions():
    xs = WIDE_EDGE + rand_ints(3, 1 << 256)
    a = tf.ints_to_limbs(xs)
    by = tf.limbs_to_be_bytes(T(a))
    assert by.shape == (32, len(xs))
    assert [bytes(by[:, j].tolist()) for j in range(len(xs))] == [
        x.to_bytes(32, "big") for x in xs
    ]
    assert same(by, jf.limbs_to_be_bytes(J(a)))
    back = tf.be_bytes_to_limbs(by)
    assert np.array_equal(back.numpy(), a)
    assert same(back, jf.be_bytes_to_limbs(J(by.numpy())))
    # non-normalized "bytes" alias exactly as in the JAX package
    odd = by.clone()
    odd[3, 0] += 256
    assert same(tf.be_bytes_to_limbs(odd), jf.be_bytes_to_limbs(J(odd.numpy())))


POWS = {
    "fp_inv": (P, P - 2),
    "fp_sqrt": (P, (P + 1) // 4),
    "fn_inv": (N, N - 2),
}


@pytest.mark.parametrize("name", sorted(POWS))
def test_fixed_window_pow(name):
    """The plain version of the exponentiation kernel: against the JAX
    package's ladder and against Python's pow; 0 maps to 0."""
    m, e = POWS[name]
    xs = [0, 1, m - 1, 2] + rand_ints(2, m)
    a = tf.ints_to_limbs(xs)
    got = getattr(tf, name)(T(a))
    assert tf.limbs_to_ints(got) == [pow(x, e, m) for x in xs]
    assert same(got, getattr(jf, name)(J(a)))


def test_pow_rejects_bad_arguments():
    from bppp_tpu_torch.ops import cuda_msm

    x = T(tf.ints_to_limbs([3]))
    with pytest.raises(ValueError):
        cuda_msm.pow_const(x, 5, "q")
    with pytest.raises(ValueError):
        cuda_msm.pow_const(x, 0, "p")
