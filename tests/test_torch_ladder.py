"""The ladder and tree-sum halves of the port's group operations
(bppp_tpu_torch.ops.cuda_ladder through ops.curve: `pt_scalar_mul`,
`pt_sum`, `msm` over more than 6 points, and the plain versions of the two
kernels) against the JAX package and the host oracle. Same numpy inputs
through both; every comparison is exact (tolerance 0): limbs where both
sides apply the same formulas in the same order, compressed bytes where
only the POINT has to agree."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu_torch.ops import _build
from bppp_tpu_torch.ops import cuda_curve, cuda_ladder
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N, P
from bppp_tpu_torch.protocol import points as pv

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

rng = np.random.default_rng(6006)


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


def J(a):
    return jnp.asarray(a.numpy().astype(np.uint32))


def to_jax(p):
    return jc.PointJ(*(J(c) for c in p))


def same(tp, jp):
    return all(
        np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)) for a, b in zip(tp, jp)
    )


def lane_bytes(b):
    return [bytes(b[:, j].tolist()) for j in range(b.shape[1])]


def grid(rows):
    """rows[l][b] oracle Points -> PointJ coords (16, L, B)."""
    return tc.PointJ(*(
        T(np.stack([tf.ints_to_limbs([getattr(p, c) for p in row]) for row in rows], axis=1))
        for c in "xyz"
    ))


def oracle_sum(points, scalars=None):
    acc = oc.IDENTITY
    for i, p in enumerate(points):
        acc = acc.add(p if scalars is None else p.mul(scalars[i]))
    return acc


G = [oc.GENERATOR.mul(rand_scalar()) for _ in range(17)]

# -- K6: the ladder ------------------------------------------------------------

LADDER_KS = {
    "zero": 0, "one": 1, "minus_one": N - 1, "two": 2, "fifteen": 15, "sixteen": 16,
    "top_nibble": 0xF << 252, "random": rand_scalar(),
}
LADDER_NAMES = sorted(LADDER_KS)


@pytest.fixture(scope="module")
def ladder():
    """ONE ladder call over all scalar cases, a random point each, plus the
    identity point under a random scalar as the last lane."""
    pts = [rescale(G[i]) for i in range(len(LADDER_NAMES))] + [oc.IDENTITY]
    ks = [LADDER_KS[n] for n in LADDER_NAMES] + [rand_scalar()]
    p = tc.from_int_points(pts, device="cpu")
    k = T(tf.ints_to_limbs(ks))
    return pts, ks, p, k, tc.pt_scalar_mul(p, k)


@pytest.mark.parametrize("name", LADDER_NAMES + ["identity_point"])
def test_pt_scalar_mul_case(ladder, name):
    pts, ks, _, _, got = ladder
    i = len(LADDER_NAMES) if name == "identity_point" else LADDER_NAMES.index(name)
    out = tc.to_int_points(got)[i]
    assert out.to_bytes() == pts[i].mul(ks[i]).to_bytes()
    if name in ("zero", "identity_point"):
        assert out.z == 0


def test_pt_scalar_mul_matches_jax_limb_for_limb(ladder):
    """The plain ladder and the JAX package's graph ladder apply the same
    adds and doubles in the same order: (X, Y, Z) agree exactly."""
    _, _, p, k, got = ladder
    assert same(got, jc._pt_scalar_mul_jnp(to_jax(p), J(k)))


def test_pt_scalar_mul_broadcasts_scalar_and_point():
    pts = tc.from_int_points(G[:3], batch=(2,), device="cpu")  # (16, 3, 2)
    ks = [rand_scalar(), 3]
    k = T(tf.ints_to_limbs(ks))[:, None]  # (16, 1, 2): one scalar per lane
    got = tc.pt_scalar_mul(pts, k)
    assert got.x.shape == (16, 3, 2)
    for b in range(2):
        assert lane_bytes(tc.compress(got)[:, :, b]) == [g.mul(ks[b]).to_bytes() for g in G[:3]]
    # generators without a batch axis of their own, through the vector helper
    shared = tc.PointJ(*(c[:, :, :1] for c in pts))  # (16, 3, 1)
    via_pv = pv.pv_scale(shared, T(tf.ints_to_limbs(ks)))
    assert all(torch.equal(a, b) for a, b in zip(via_pv, got))


# -- K7: the sum over a points axis -------------------------------------------------

a, b = rescale(G[0]), rescale(G[1])
INC_CASES = {
    "generic": (a, b, a.add(b)),
    "p_identity": (oc.IDENTITY, b, b),
    "q_identity": (a, oc.IDENTITY, a),
    "both_identity": (oc.IDENTITY, oc.IDENTITY, oc.IDENTITY),
    # the incomplete add does not handle collisions: they degrade to z = 0
    "doubling_degrades": (a, rescale(a), oc.IDENTITY),
    "inverse_degrades": (a, rescale(neg(a)), oc.IDENTITY),
}


@pytest.mark.parametrize("case", sorted(INC_CASES))
def test_pt_add_inc_plain_case(case):
    p, q, want = INC_CASES[case]
    pj = tc.from_int_points([p, G[2]], device="cpu")
    qj = tc.from_int_points([q, G[3]], device="cpu")
    got = tc.PointJ(*cuda_ladder.pt_add_inc_plain(*pj, *qj))
    out = tc.to_int_points(got)
    assert out[0].to_bytes() == want.to_bytes()
    assert out[1].to_bytes() == G[2].add(G[3]).to_bytes()
    if case.endswith("degrades"):
        assert out[0].z == 0
    else:  # where no collision is hit it is the complete add, limb for limb
        assert all(torch.equal(x, y) for x, y in zip(got, tc.pt_add(pj, qj)))


SUM_ROWS = [[rescale(G[l + b]) for b in range(2)] for l in range(5)]
SUM_ROWS[0][1] = oc.IDENTITY
SUM_ROWS[3][0] = oc.IDENTITY
SUM_ROWS[4][1] = oc.IDENTITY


@pytest.mark.parametrize("L", [1, 2, 5])
def test_pt_sum_matches_oracle_and_pairwise_reduction(L):
    p = grid(SUM_ROWS[:L])
    got = tc.pt_sum(p)
    assert got.x.shape == (16, 2)
    want = [oracle_sum([row[b] for row in SUM_ROWS[:L]]).to_bytes() for b in range(2)]
    assert lane_bytes(tc.compress(got)) == want
    pairwise = tc.PointJ(*cuda_curve.tree_sum_plain(*p))
    assert lane_bytes(tc.compress(pairwise)) == want


def test_pt_sum_matches_jax():
    p = grid(SUM_ROWS)
    got = tc.compress(tc.pt_sum(p))
    assert np.array_equal(got.numpy(), np.asarray(jc.compress(jc.pt_sum(to_jax(p)))).astype(np.int64))


def test_pt_sum_honours_axis():
    p = grid(SUM_ROWS)  # (16, 5, 2)
    swapped = tc.PointJ(*(c.movedim(1, 2).contiguous() for c in p))  # (16, 2, 5)
    assert all(torch.equal(x, y) for x, y in zip(tc.pt_sum(swapped, axis=2), tc.pt_sum(p)))
    stacked = tc.PointJ(*(torch.stack([c, c], dim=2) for c in p))  # (16, 5, 2, 2)
    got = tc.pt_sum(stacked)
    assert got.x.shape == (16, 2, 2)
    assert torch.equal(got.x[:, 0], tc.pt_sum(p).x) and torch.equal(got.x[:, 1], tc.pt_sum(p).x)


def test_all_identity_sum_is_identity():
    got = tc.pt_sum(tc.identity((4, 3), device="cpu"))
    assert tc.pt_is_identity(got).all() and int(tc.compress(got).abs().sum()) == 0


# -- msm over more than 6 points ------------------------------------------------------


def _msm_inputs(L, B=2):
    ks = [[rand_scalar() for _ in range(B)] for _ in range(L)]
    ks[0][0] = 0
    ks[1][1] = N - 1
    ks[2][0] = 1
    sc = T(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))  # (16, L, B)
    want = [oracle_sum(G[:L], [row[b] for row in ks]).to_bytes() for b in range(B)]
    return sc, want


MSM_INPUTS = {L: _msm_inputs(L) for L in (7, 17)}


@pytest.mark.parametrize("L", [7, 17])
def test_msm_many_points_matches_oracle(L):
    """L > 6: one ladder over L * B lanes and one sum over L. Shared
    generators (no batch axis of their own) are expanded for the launch."""
    sc, want = MSM_INPUTS[L]
    batched = tc.from_int_points(G[:L], batch=(2,), device="cpu")
    got = tc.msm(batched, sc)
    assert got.x.shape == (16, 2)
    assert lane_bytes(tc.compress(got)) == want
    shared = tc.PointJ(*(c[:, :, :1] for c in batched))  # (16, L, 1)
    assert all(torch.equal(x, y) for x, y in zip(tc.msm(shared, sc), got))


def test_msm_front_end_pads_a_short_scalar_vector():
    """`points.msm` zero-pads the scalars to the points' length: the padded
    terms add the identity."""
    sc, _ = MSM_INPUTS[7]
    pts = tc.from_int_points(G[:8], batch=(2,), device="cpu")
    got = tc.compress(pv.msm(pts, sc))
    want = tc.compress(tc.msm(tc.PointJ(*(c[:, :7] for c in pts)), sc))
    assert torch.equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("L", [7, 17])
def test_msm_many_points_matches_jax(L):
    """Against the JAX package's `msm`, which on the CPU is its bucketed
    Pippenger: another route to the same point, so compressed bytes. Slow:
    run op by op its sort-and-scan graph takes minutes."""
    sc, want = MSM_INPUTS[L]
    pts = tc.from_int_points(G[:L], batch=(2,), device="cpu")
    jgot = np.asarray(jc.compress(jc.msm(to_jax(pts), J(sc)))).astype(np.int64)
    assert lane_bytes(torch.from_numpy(jgot)) == want
    assert np.array_equal(tc.compress(tc.msm(pts, sc)).numpy(), jgot)


# -- wrappers and build list ------------------------------------------------------------


def test_wrappers_reject_bad_shapes():
    p = tc.from_int_points(G[:2], device="cpu")
    with pytest.raises(ValueError):
        cuda_ladder.tree_sum(*(c[:, :0] for c in p))
    with pytest.raises(ValueError):
        cuda_ladder.tree_sum(p.x, p.y, p.z[:, :1])
    with pytest.raises(ValueError):
        cuda_ladder.scalar_mul(*(c[:8] for c in p), T(tf.ints_to_limbs([1, 2]))[:8])
    with pytest.raises(ValueError):
        tc.msm(tc.PointJ(*(c[:, :0] for c in p)), torch.zeros((16, 0), dtype=torch.int64))


def test_plain_call_counters_count_and_launch_counters_do_not():
    before = dict(cuda_ladder.PLAIN_CALLS), dict(cuda_ladder.LAUNCHES)
    p = grid(SUM_ROWS[:2])
    tc.pt_sum(p)
    assert cuda_ladder.PLAIN_CALLS["tree_sum"] == before[0]["tree_sum"] + 1
    assert cuda_ladder.LAUNCHES == before[1]


def test_every_kernel_source_is_built():
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    on_disk = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))
    assert sorted(_build.SOURCES) == on_disk and "ladder" in on_disk
    with open(os.path.join(csrc, "ladder.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int bppp_scalar_mul(' in src and 'extern "C" int bppp_tree_sum(' in src
