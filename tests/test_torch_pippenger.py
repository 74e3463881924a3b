"""The port's bucketed Pippenger MSM (`ops/pippenger.py`) against the host
oracle and the JAX package: results compared as points (the order among
equal digits, and so the Jacobian limbs, may differ), on lanes with an
identity point, a zero scalar and repeated points. `slow`: against the
JAX `msm_pippenger` (op by op on the CPU, minutes)."""

import numpy as np
import pytest
import torch

from bppp_tpu.ops import pippenger as jpip
from bppp_tpu_torch.ops import cuda_ladder
from bppp_tpu_torch.ops import curve as dc
from bppp_tpu_torch.ops import field as f
from bppp_tpu_torch.ops import pippenger as pip
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.utils.rng import SeededRng

B = 2


def _instance(L: int, seed: str):
    """B lanes of L random points and scalars; lane 0 has an identity point
    (1), a zero scalar (2) and a point repeated with its scalar (3 == 4),
    lane 1 one point three times with different scalars (5, 6, 7) and a
    scalar n - 1. -> (points, scalars as oracle lists, PointJ, limbs)."""
    rng = SeededRng(seed)
    pts = [[oc.GENERATOR.mul(rng.scalar()) for _ in range(L)] for _ in range(B)]
    scs = [rng.scalars(L) for _ in range(B)]
    pts[0][1] = oc.IDENTITY
    scs[0][2] = 0
    pts[0][4], scs[0][4] = pts[0][3], scs[0][3]
    pts[1][5] = pts[1][6] = pts[1][7]
    scs[1][0] = N - 1
    P = dc.PointJ(*(torch.from_numpy(np.stack(
        [f.ints_to_limbs([getattr(p, a) for p in lane]) for lane in pts], axis=-1))
        for a in "xyz"))
    S = torch.from_numpy(np.stack([f.ints_to_limbs(s) for s in scs], axis=-1))
    return pts, scs, P, S


def _oracle_msm(pts, scs):
    acc = oc.IDENTITY
    for p, s in zip(pts, scs):
        acc = acc.add(p.mul(s))
    return acc


@pytest.mark.parametrize("L, c", [(16, 4), (8, 8)])
def test_msm_pippenger_matches_the_oracle(L, c):
    pts, scs, P, S = _instance(L, f"pippenger {L} {c}")
    before = dict(cuda_ladder.PLAIN_CALLS)
    got = pip.msm_pippenger(P, S, c)
    assert cuda_ladder.PLAIN_CALLS == before  # neither K6 nor K7 (incomplete adds)
    for b in range(B):
        assert cv.point_lane(got, b).to_bytes() == _oracle_msm(pts[b], scs[b]).to_bytes(), b


def test_pick_c_and_digits_match_the_jax_package():
    for L in (1, 33, 112, 113, 129):
        assert pip._pick_c(L) == jpip._pick_c(L)
    _, _, P, S = _instance(8, "pippenger digits")
    for c in (1, 2, 4, 8, 16):
        got = pip._digits_all(S, c)
        want = np.asarray(jpip._digits_all(S.numpy().astype(np.uint32), c))
        assert tuple(got.shape) == want.shape == (256 // c, 8, B)
        assert np.array_equal(got.numpy(), want.astype(np.int64)), c
    with pytest.raises(ValueError):
        pip.msm_pippenger(P, S, c=3)


def test_prefix_sums_are_complete_over_equal_points():
    """The scan adds equal points (a doubling collision) and a point to its
    negation: its adds must be the complete ones."""
    g = oc.GENERATOR.mul(7)
    seq = [g, g, g.neg(), g, oc.IDENTITY]
    P = dc.PointJ(*(torch.from_numpy(f.ints_to_limbs([getattr(p, a) for p in seq]))[:, :, None]
                    for a in "xyz"))
    pre = pip._prefix_pt_sum(P)
    acc = oc.IDENTITY
    for j, p in enumerate(seq):
        acc = acc.add(p)
        assert cv.point_vec_lane(pre, 0)[j].to_bytes() == acc.to_bytes(), j


@pytest.mark.slow
def test_msm_pippenger_matches_the_jax_pippenger():
    pts, scs, P, S = _instance(16, "pippenger jax")
    got = pip.msm_pippenger(P, S, 4)
    ref = cv.to_reference
    want = jpip.msm_pippenger(type(P)(*(ref(a) for a in P)), ref(S), 4)
    for b in range(B):
        theirs = oc.Point(*(f.limbs_to_ints(np.asarray(a)[:, b:b + 1].astype(np.int64))[0]
                            for a in want))
        assert cv.point_lane(got, b).to_bytes() == theirs.to_bytes() == \
            _oracle_msm(pts[b], scs[b]).to_bytes()
