"""K6's GLV walk and K5b's doubling chain on the CPU.

K6 (`csrc/ladder.cu`) splits each scalar in the kernel, k = k1 + k2 lambda
(mod n), and walks the two halves over 33 windows with incomplete adds:
two threads per lane joined by one complete add, or one thread with one
accumulator (`cuda_ladder.scalar_mul_plan` chooses). Both decompositions
are mirrored here in plain PyTorch, step for step, and give the plain
ladder's point and the JAX package's host oracle's on edge lanes. K5b's
plain chain equals single doubles and the JAX package's double, limb for
limb; the table build's batched inversion equals one inversion per entry.
Every comparison is exact (tolerance 0): compressed bytes where the adds
differ, limbs where the formulas are the same."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.oracle import curve as jc
from bppp_tpu.ops import curve as jcurve
from bppp_tpu_torch.ops import cuda_curve, cuda_fixed_base, cuda_ladder, cuda_msm
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv as tglv
from bppp_tpu_torch.oracle.field import N
from test_torch_msm_small_split import join_in_kernel_order
from test_torch_msm_u4_split import slot_walks

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

rng = np.random.default_rng(6606)


def rand_scalar():
    return int.from_bytes(rng.bytes(40), "big") % N


LAM = tglv.LAMBDA
# the kernel's edge scalars: k1 = 0 (lambda), k2 = 0 (5, 0x1F), a negative
# k1 (n - 1), a negative k2 (n - lambda), both halves live (1 + lambda,
# 2^128 + 1, random), scalars at or above n (n + 5, 2^256 - 1: the kernel
# reduces k once, the plain ladder walks it as it is); the last lane carries
# the identity point
EDGE = {"zero": 0, "one": 1, "minus_one": N - 1, "lambda": LAM, "one_plus_lambda": 1 + LAM,
        "minus_lambda": N - LAM, "five": 5, "two_128_plus_one": (1 << 128) + 1, "small": 0x1F,
        "random": rand_scalar(), "n_plus_5": N + 5, "all_ones": (1 << 256) - 1,
        "identity_point": rand_scalar()}
NAMES = list(EDGE)


def to_t(pts):
    return tc.PointJ(*(torch.from_numpy(tf.ints_to_limbs([getattr(p, c) for p in pts]))
                       for c in "xyz"))


@pytest.fixture(scope="module")
def lanes():
    """One lane per edge scalar, a random point each (the identity on the
    last): the points, the scalars, the oracle's bytes and the plain
    ladder's result."""
    pts = [jc.GENERATOR.mul(rand_scalar()) for _ in NAMES]
    pts[-1] = jc.IDENTITY
    ks = [EDGE[n] for n in NAMES]
    p = to_t(pts)
    k = torch.from_numpy(tf.ints_to_limbs(ks))
    want = [q.mul(kv).to_bytes() for q, kv in zip(pts, ks)]
    plain = tc.compress(tc.PointJ(*cuda_ladder.scalar_mul_plain(*p, k)))
    return p, k, want, plain


def lane_bytes(b):
    return [bytes(b[:, j].tolist()) for j in range(b.shape[1])]


def halves(k):
    """glv.decompose as the kernel holds it, after reducing k below 2^256
    once (k < 2n): magnitudes (2, 16, B), negate masks (2, B)."""
    m1, n1, m2, n2 = tglv.decompose(tf.fn_add(k, torch.zeros_like(k)))
    return torch.stack([m1, m2]), torch.stack([n1, n2])


def k6_split(px, py, pz, k):
    """The split launch: slot j walks half j over the plain table of P
    (33 windows, 4 doubles, an incomplete add per nonzero digit), x times
    beta on the k2 slot's partial and y negated on a negative half's, once;
    the two partials join with a complete add."""
    mags, signs = halves(k)
    tab = cuda_msm._tables_plain(px[None], py[None], pz[None], 16)
    mm = mags.movedim(0, 1)  # (16, 2, B)
    part = slot_walks(tab, lambda w: (mm[w // 4] >> (4 * (w % 4))) & 15, torch.tensor([0, 0]),
                      tglv.GLV_WINDOWS)
    part = cuda_msm._beta_neg(part, torch.tensor([False, True]), signs)
    return join_in_kernel_order(*part)


def k6_lane(px, py, pz, k):
    """The lane walk: one accumulator over 33 windows (4 doubles each, the
    first on the identity), then per half an incomplete add of its entry,
    beta x on the k2 half's, -y on a negative half's."""
    mags, signs = halves(k)
    tab = cuda_msm._tables_plain(px[None], py[None], pz[None], 16)
    acc = tuple(tc.identity(k.shape[1:], device="cpu"))
    for w in range(tglv.GLV_WINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = cuda_curve.pt_double_plain(*acc)
        for j in range(2):
            digit = (mags[j][w // 4] >> (4 * (w % 4))) & 15
            q = cuda_msm._select_plain(tab, digit[None], torch.tensor([0]))
            q = cuda_msm._beta_neg(q, torch.tensor([j == 1]), signs[j][None])
            acc = cuda_ladder.pt_add_inc_plain(*acc, *(c[:, 0] for c in q))
    return acc


def test_edge_scalars_split_as_the_kernel_expects(lanes):
    _, k, _, _ = lanes
    mags, signs = halves(k)
    i = NAMES.index
    assert int(mags[0][:, i("lambda")].abs().sum()) == 0  # k1 = 0
    assert int(mags[1][:, i("five")].abs().sum()) == 0  # k2 = 0
    assert bool(signs[0, i("minus_one")]) and bool(signs[1, i("minus_lambda")])
    # n + 5 splits as 5 does
    assert torch.equal(mags[:, :, i("n_plus_5")], mags[:, :, i("five")])
    assert int(mags[:, 9:].abs().sum()) == 0  # below 2^144
    assert int((mags[:, 8] >> 4).abs().sum()) == 0  # below 2^132: 33 windows


@pytest.mark.parametrize("launch", ["split", "lane"])
def test_glv_walks_give_the_plain_ladder_and_the_oracle(lanes, launch):
    p, k, want, plain = lanes
    got = (k6_split if launch == "split" else k6_lane)(*p, k)
    got = tc.compress(tc.PointJ(*got))
    assert torch.equal(got, plain)
    assert lane_bytes(got) == want
    assert int(got[:, NAMES.index("zero")].abs().sum()) == 0
    assert int(got[:, NAMES.index("identity_point")].abs().sum()) == 0


# where one thread per lane won the sweep of both launches on the H100
# (tools/compare_designs.py, PERF.md; at 16384 the split won by 5 % timed in
# turns). At 12288, which no path gives, the lane walk was 2 % ahead in turns
# and the plan, a threshold, splits it as it splits 16384.
LANE_WALK_WON = {17408, 32768, 66560, 132096}


@pytest.mark.parametrize("B", [1, 203, 1024, 2048, 4096, 8192, 12288, 16384, 17408, 32768,
                               66560, 132096])
def test_scalar_mul_plan_splits_up_to_the_measured_threshold(B):
    """Two threads per lane while 2 B <= K6_SPLIT_THREADS, one beyond; at
    every swept lane count the plan takes the launch that won. A block
    fits K6_BLOCK threads."""
    nthr, lpb = cuda_ladder.scalar_mul_plan(B)
    assert nthr == (2 if 2 * B <= cuda_ladder.K6_SPLIT_THREADS else 1)
    assert 1 <= lpb and nthr * lpb <= cuda_ladder.K6_BLOCK
    assert lpb == (cuda_ladder.K6_BLOCK // 2 if nthr == 2 else cuda_ladder.K6_LANE_BLOCK)
    if B >= 1024:
        assert (nthr == 1) == (B in LANE_WALK_WON)


# -- K5b -------------------------------------------------------------------------


def test_double_chain_equals_single_doubles_and_the_jax_double():
    """n = 5 doubles of 3 lanes (one the identity): the chain's double t
    equals t single doubles and the JAX package's `_pt_double_jnp` applied
    t times, limb for limb."""
    pts = [jc.GENERATOR.mul(rand_scalar()) for _ in range(3)]
    pts[1] = jc.IDENTITY
    p = to_t(pts)
    chain = cuda_curve.pt_double_chain_plain(*p, 5)
    assert all(c.shape == (16, 5, 3) for c in chain)
    q = tuple(p)
    jq = jcurve.PointJ(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))
    for t in range(5):
        q = cuda_curve.pt_double_plain(*q)
        jq = jcurve._pt_double_jnp(jq)
        for c in range(3):
            assert torch.equal(chain[c][:, t], q[c])
            assert np.array_equal(chain[c][:, t].numpy(), np.asarray(jq[c]).astype(np.int64))
    assert int(chain[2][:, :, 1].abs().sum()) == 0  # the identity stays the identity


def test_double_chain_wrapper_takes_the_plain_chain_on_the_cpu_and_rejects_an_empty_one():
    p = to_t([jc.GENERATOR])
    got = cuda_curve.pt_double_chain(*p, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_curve.pt_double_chain_plain(*p, 2)))
    with pytest.raises(ValueError):
        cuda_curve.pt_double_chain(*p, 0)


def jacobian_rows(M, NE, dead):
    """M rows of NE random points in random Jacobian representations, the
    entries at the flat indices `dead` the identity. -> coords (16, M, NE)
    and the same points flat, (16, M NE)."""
    pts = [jc.GENERATOR.mul(rand_scalar()) for _ in range(M * NE)]
    for i in dead:
        pts[i] = jc.IDENTITY
    flat = to_t(pts)
    z = torch.from_numpy(tf.ints_to_limbs([rand_scalar() or 1 for _ in pts]))
    z2 = tf.fp_mul(z, z)
    flat = tc.PointJ(tf.fp_mul(flat.x, z2), tf.fp_mul(flat.y, tf.fp_mul(z2, z)),
                     tf.fp_mul(flat.z, z))
    return tc.PointJ(*(c.reshape(16, M, NE) for c in flat)), flat


def test_batched_affine_equals_one_inversion_per_entry():
    """The table build's affine step over (16, M, NE) entries, some the
    identity (a row's first, as in a table): the wrapper on the CPU (the
    plain product tree) equals the port's `to_affine` and the JAX
    package's, one inversion per entry, limb for limb."""
    rows, flat = jacobian_rows(2, 4, (0, 4, 5))
    x, y = cuda_curve.affine_rows(*rows)
    wx, wy, _ = tc.to_affine(flat)
    assert torch.equal(x.reshape(16, 8), wx) and torch.equal(y.reshape(16, 8), wy)
    jx, jy, _ = jcurve.to_affine(jcurve.PointJ(*(jnp.asarray(c.numpy().astype(np.uint32))
                                                 for c in flat)))
    assert np.array_equal(np.asarray(jx).astype(np.int64), wx.numpy())
    assert np.array_equal(np.asarray(jy).astype(np.int64), wy.numpy())
    with pytest.raises(ValueError):
        cuda_curve.affine_rows(*(c[:, :, :3] for c in rows))


def affine_rows_in_kernel_order(X, Y, Z):
    """The kernel's walk of a row in plain PyTorch: prefix products of the
    Z up the row (an identity's Z as 1), one inversion of the last, then
    down the row Z_e^-1 = running inverse x prefix before e, x = X Z^-2,
    y = Y Z^-3, zero on identities."""
    M, NE = X.shape[1:]
    is_id = tf.fp_is_zero(Z)
    one = torch.zeros_like(Z[:, :, 0])
    one[0] = 1
    pre, acc = [], one
    for e in range(NE):
        acc = torch.where(is_id[:, e], acc, tf.fp_mul(acc, Z[:, :, e]))
        pre.append(acc)
    inv = tf.fp_inv(acc)
    xs, ys = [None] * NE, [None] * NE
    for e in range(NE - 1, -1, -1):
        zi = tf.fp_mul(inv, pre[e - 1] if e else one)
        inv = torch.where(is_id[:, e], inv, tf.fp_mul(inv, Z[:, :, e]))
        zi2 = tf.fp_sqr(zi)
        x = tf.fp_mul(X[:, :, e], zi2)
        y = tf.fp_mul(Y[:, :, e], tf.fp_mul(zi2, zi))
        xs[e] = torch.where(is_id[:, e], torch.zeros_like(x), x)
        ys[e] = torch.where(is_id[:, e], torch.zeros_like(y), y)
    return torch.stack(xs, dim=2), torch.stack(ys, dim=2)


def test_affine_rows_kernel_order_equals_the_product_tree():
    """One inversion per row along the row, as the kernel walks it, gives
    the plain version's limbs: a row with only its first entry the
    identity, one with identities inside, and one all identities."""
    rows, _ = jacobian_rows(3, 4, (0, 4, 6, 8, 9, 10, 11))
    got = affine_rows_in_kernel_order(*rows)
    want = cuda_curve.affine_rows_plain(*rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[0][:, 2].abs().sum()) == 0  # the row of identities
