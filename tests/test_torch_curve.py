"""The port's group operations (bppp_tpu_torch.ops.curve, .glv and the
plain versions of the point-add and small-MSM kernels) against the JAX
package and the host oracle. Same numpy inputs through both; every
comparison is exact (tolerance 0): limbs where both sides apply the same
formulas, compressed bytes where only the POINT has to agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu.ops import glv as jglv
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv as tglv
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N, P

rng = np.random.default_rng(4242)


def rand_scalar():
    return int.from_bytes(rng.bytes(40), "big") % N


def rescale(p):
    """The same point in another Jacobian representation."""
    z = int.from_bytes(rng.bytes(32), "big") % P or 1
    return oc.Point(p.x * z * z % P, p.y * z * z * z % P, p.z * z % P)


def neg(p):
    return oc.Point(p.x, (P - p.y) % P, p.z)


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def to_jax(p):
    return jc.PointJ(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))


def same(tp, jp):
    return all(
        np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)) for a, b in zip(tp, jp)
    )


def lane_bytes(b):
    return [bytes(b[:, j].tolist()) for j in range(b.shape[1])]


G = [oc.GENERATOR.mul(rand_scalar()) for _ in range(6)]
# the four masked cases of the complete add, then generic lanes
ADD_CASES = {
    "generic": (rescale(G[0]), rescale(G[1])),
    "doubling": (rescale(G[2]), rescale(G[2])),
    "inverse": (rescale(G[3]), rescale(neg(G[3]))),
    "p_identity": (oc.IDENTITY, rescale(G[4])),
    "q_identity": (rescale(G[5]), oc.IDENTITY),
    "both_identity": (oc.IDENTITY, oc.IDENTITY),
}


@pytest.mark.parametrize("case", sorted(ADD_CASES))
def test_pt_add_case(case):
    a, b = ADD_CASES[case]
    p = tc.from_int_points([a, G[0]], device="cpu")
    q = tc.from_int_points([b, G[1]], device="cpu")
    got = tc.pt_add(p, q)
    assert [g.to_bytes() for g in tc.to_int_points(got)] == [
        a.add(b).to_bytes(), G[0].add(G[1]).to_bytes()
    ]
    assert same(got, jc._pt_add_jnp(to_jax(p), to_jax(q)))


def test_pt_add_broadcasts():
    p = tc.from_int_points(G[:3], batch=(2,), device="cpu")  # (16, 3, 2)
    q = tc.from_int_points([G[4]], batch=(2,), squeeze=True, device="cpu")  # (16, 2)
    got = tc.pt_add(p, tc.PointJ(*(c[:, None] for c in q)))
    assert got.x.shape == (16, 3, 2)
    want = [g.add(G[4]).to_bytes() for g in G[:3]]
    assert lane_bytes(tc.compress(got)[:, :, 0]) == want


def test_pt_double_and_neg():
    pts = [rescale(g) for g in G[:3]] + [oc.IDENTITY]
    p = tc.from_int_points(pts, device="cpu")
    got = tc.pt_double(p)
    assert [g.to_bytes() for g in tc.to_int_points(got)] == [
        q.double().to_bytes() for q in pts
    ]
    assert same(got, jc._pt_double_jnp(to_jax(p)))
    assert same(tc.pt_neg(p), jc.pt_neg(to_jax(p)))


def test_pt_eq_and_select():
    a = tc.from_int_points([rescale(G[0]), G[1], oc.IDENTITY, G[2], oc.IDENTITY], device="cpu")
    b = tc.from_int_points([rescale(G[0]), neg(G[1]), oc.IDENTITY, oc.IDENTITY, G[3]], device="cpu")
    got = tc.pt_eq(a, b)
    assert got.tolist() == [True, False, True, False, False]
    assert np.array_equal(got.numpy(), np.asarray(jc.pt_eq(to_jax(a), to_jax(b))))
    assert tc.pt_is_identity(a).tolist() == [False, False, True, False, True]
    sel = tc.pt_select(got, a, b)
    assert same(sel, jc.pt_select(jnp.asarray(got.numpy()), to_jax(a), to_jax(b)))


def test_identity_generator_and_host_bridges():
    idl = tc.identity((3,), device="cpu")
    assert same(idl, jc.identity((3,)))
    gen = tc.generator((2,), device="cpu")
    assert same(gen, jc.generator((2,)))
    pts = tc.from_int_points(G[:2], batch=(3,), device="cpu")
    assert same(pts, jc.from_int_points(G[:2], batch=(3,)))
    assert [p.to_bytes() for p in tc.to_int_points(tc.from_int_points(G, device="cpu"))] == [
        g.to_bytes() for g in G
    ]


def test_compress_decompress_roundtrip():
    pts = [rescale(g) for g in G] + [oc.IDENTITY]
    p = tc.from_int_points(pts, device="cpu")
    by = tc.compress(p)
    assert by.shape == (33, len(pts)) and by.dtype == torch.int64
    assert lane_bytes(by) == [q.to_bytes() for q in pts]
    assert np.array_equal(by.numpy(), np.asarray(jc.compress(to_jax(p))).astype(np.int64))
    back = tc.decompress(by)
    assert tc.pt_eq(back, p).all()
    assert same(back, jc.decompress(jnp.asarray(by.numpy().astype(np.uint32))))
    x, y, is_id = tc.to_affine(p)
    jx, jy, jid = jc.to_affine(to_jax(p))
    assert same((x, y), (jx, jy)) and np.array_equal(is_id.numpy(), np.asarray(jid))


def _malformed():
    good = np.frombuffer(G[0].to_bytes(), dtype=np.uint8).astype(np.int64)
    x_nr = next(x for x in range(2, 100) if pow(x**3 + 7, (P - 1) // 2, P) != 1)
    cases = {"valid": (good.copy(), True), "identity": (np.zeros(33, np.int64), True)}
    b = good.copy(); b[0] = 7
    cases["bad_tag"] = (b, False)
    b = good.copy(); b[0] = 0  # tag 0 with a nonzero x is no identity
    cases["zero_tag"] = (b, False)
    b = good.copy(); b[1:] = 0xFF
    cases["x_not_below_p"] = (b, False)
    b = good.copy(); b[1:] = list(x_nr.to_bytes(32, "big"))
    cases["non_residue"] = (b, False)
    b = good.copy()
    k = next(j for j in range(1, 32, 2) if b[j] >= 1)
    b[k] -= 1; b[k + 1] += 256  # same x under be_bytes_to_limbs, another encoding
    cases["byte_over_255"] = (b, False)
    return cases


MALFORMED = _malformed()


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_decompress_checked(case):
    """Valid and each kind of malformed encoding: the lane is accepted or
    rejected, nothing raises, and the JAX package decides the same."""
    col, want = MALFORMED[case]
    by = np.stack([col, MALFORMED["valid"][0]], axis=1)
    pt, ok = tc.decompress_checked(torch.from_numpy(by))
    assert ok.tolist() == [want, True]
    jpt, jok = jc.decompress_checked(jnp.asarray(by.astype(np.uint32)))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert same(pt, jpt)


def test_decompress_checked_rejects_negative_bytes():
    by = np.stack([MALFORMED["valid"][0]] * 2, axis=1)
    by[5, 0] -= 256
    _, ok = tc.decompress_checked(torch.from_numpy(by))
    assert ok.tolist() == [False, True]


@pytest.mark.parametrize("L", [2, 5])
def test_msm_small(L):
    """`msm` for a few per-proof points — GLV split, signed digits, and the
    plain version of the small-MSM kernel — against the JAX package's msm
    and the oracle, as compressed bytes."""
    B = 2
    pts = [[rescale(oc.GENERATOR.mul(rand_scalar())) for _ in range(B)] for _ in range(L)]
    ks = [[rand_scalar() for _ in range(B)] for _ in range(L)]
    ks[0][0] = 0
    ks[1][1] = N - 1
    pts[L - 1][0] = oc.IDENTITY
    coords = [
        T(np.stack([tf.ints_to_limbs([getattr(p, c) for p in row]) for row in pts], axis=1))
        for c in "xyz"
    ]  # (16, L, B)
    sc = T(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))
    got = tc.compress(tc.msm(tc.PointJ(*coords), sc))
    for b in range(B):
        want = oc.IDENTITY
        for i in range(L):
            want = want.add(pts[i][b].mul(ks[i][b]))
        assert bytes(got[:, b].tolist()) == want.to_bytes()
    jgot = jc.compress(jc.msm(to_jax(coords), jnp.asarray(sc.numpy().astype(np.uint32))))
    assert np.array_equal(got.numpy(), np.asarray(jgot).astype(np.int64))


def test_msm_six_points_chunks_and_more_raise():
    B = 1
    pts = tc.from_int_points(G, batch=(B,), device="cpu")
    ks = [rand_scalar() for _ in range(6)]
    sc = T(tf.ints_to_limbs(ks))[:, :, None]
    got = tc.compress(tc.msm(pts, sc))
    want = oc.IDENTITY
    for g, k in zip(G, ks):
        want = want.add(g.mul(k))
    assert bytes(got[:, 0].tolist()) == want.to_bytes()
    # a seventh point leaves the small-MSM kernel for the ladder and the sum
    # over the points axis: same oracle, same bytes
    seven = tc.PointJ(*(torch.cat([c, c[:, :1]], dim=1) for c in pts))
    got = tc.compress(tc.msm(seven, torch.cat([sc, sc[:, :1]], dim=1)))
    assert bytes(got[:, 0].tolist()) == want.add(G[0].mul(ks[0])).to_bytes()


def test_msm_straus_matches_oracle():
    B = 2
    pts = tc.from_int_points(G[:3], batch=(B,), device="cpu")
    ks = [[rand_scalar() for _ in range(B)] for _ in range(3)]
    ks[2][0] = 0
    sc = T(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))
    got = tc.compress(tc.msm_straus(pts, sc))
    for b in range(B):
        want = oc.IDENTITY
        for g, row in zip(G, ks):
            want = want.add(g.mul(row[b]))
        assert bytes(got[:, b].tolist()) == want.to_bytes()


GLV_EDGE = [0, 1, N - 1, N // 2, N // 2 + 1, tglv.LAMBDA, (1 << 128) - 1, 1 << 255]


def test_glv_decompose_and_digits():
    """decompose and wnaf_digits element for element against the JAX
    package, and the identities they promise."""
    ks = GLV_EDGE + [rand_scalar() for _ in range(24)]
    k = tf.ints_to_limbs(ks)
    m1, n1, m2, n2 = tglv.decompose(T(k))
    j1, jn1, j2, jn2 = jglv.decompose(jnp.asarray(k.astype(np.uint32)))
    assert same((m1, m2), (j1, j2))
    assert np.array_equal(n1.numpy(), np.asarray(jn1)) and np.array_equal(n2.numpy(), np.asarray(jn2))
    a, b = tf.limbs_to_ints(m1), tf.limbs_to_ints(m2)
    for i, kv in enumerate(ks):
        s1 = -a[i] if n1[i] else a[i]
        s2 = -b[i] if n2[i] else b[i]
        assert (s1 + s2 * tglv.LAMBDA - kv) % N == 0
        assert a[i] < (1 << 130) and b[i] < (1 << 130)
    for m, n, jm, jn in ((m1, n1, j1, jn1), (m2, n2, j2, jn2)):
        d = tglv.wnaf_digits(m, n)
        assert d.shape == (tglv.GLV_WINDOWS, len(ks))
        assert np.array_equal(d.numpy(), np.asarray(jglv.wnaf_digits(jm, jn)).astype(np.int64))
        mags, signs = (d & 15).numpy(), (d >> 4).numpy()
        assert mags.max() <= 8
        vals = tf.limbs_to_ints(m)
        for i in range(len(ks)):
            total = sum(
                (-1 if signs[w, i] ^ int(n[i]) else 1) * int(mags[w, i]) << (4 * w)
                for w in range(tglv.GLV_WINDOWS)
            )
            assert total == vals[i]
