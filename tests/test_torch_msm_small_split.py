"""K4's launch decomposition on the CPU: the wrapper's plan
(`cuda_msm.msm_small_wnaf_plan`) gives each lane several threads, each
walking whole GLV halves, and the per-thread partial sums joined in the kernel's
order (`csrc/msm_small.cu`, `csrc/join.cuh`) give the plain version's
point and the JAX package's oracle sum. Every comparison is exact
(tolerance 0): compressed bytes, since the split changes (X, Y, Z) and not
the point."""

import numpy as np
import pytest
import torch

from bppp_tpu.oracle import curve as jc
from bppp_tpu_torch.ops import cuda_curve, cuda_msm
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv as tglv
from bppp_tpu_torch.oracle.field import N

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

B = 2


@pytest.mark.parametrize("B_", [1, 70, 1024, 4096, 8192, 16384])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
def test_plan_gives_whole_halves_to_each_thread(D, B_):
    """2D threads per lane (one GLV half each) up to K4_LANE_WALK_ABOVE
    lanes, one thread per lane beyond, where the card is full: the launch
    that won the sweep of both on the H100 (tools/compare_designs.py,
    PERF.md) at every D up to 4096 lanes, at 16384, and at 8192 for D >= 3.
    A block fits 128 threads, and the split's tables and join fit the
    shared-memory budget."""
    nthr, lpb = cuda_msm.msm_small_wnaf_plan(D, B_)
    assert nthr == (2 * D if B_ <= cuda_msm.K4_LANE_WALK_ABOVE else 1)
    assert 1 <= lpb and nthr * lpb <= cuda_msm.K4_BLOCK
    if nthr > 1:
        assert lpb == cuda_msm.K4_BLOCK // nthr
        assert cuda_msm.k4_smem_bytes(D, lpb) <= cuda_msm.K4_SMEM
    if B_ <= 4096:
        assert nthr == 2 * D
    if B_ == 16384 or (B_ == 8192 and D >= 3):
        assert nthr == 1


def join_in_kernel_order(x, y, z):
    """(16, n, B) partials of n slots -> slot 0's total, joined as
    `csrc/join.cuh` joins them: while m > 1, h = ceil(m / 2) and slot
    s < m - h adds slot s + h."""
    x, y, z = x.clone(), y.clone(), z.clone()
    m = x.shape[1]
    while m > 1:
        h = (m + 1) // 2
        k = m - h
        x[:, :k], y[:, :k], z[:, :k] = cuda_curve.pt_add_plain(
            x[:, :k], y[:, :k], z[:, :k], x[:, h:m], y[:, h:m], z[:, h:m])
        m = h
    return x[:, 0], y[:, 0], z[:, 0]


def split_walk(px, py, pz, dig, nthr):
    """The kernel's decomposition in plain PyTorch: slot s walks halves
    [s * h, (s + 1) * h), h = 2D / nthr, over the 33 windows MSB first (4
    doubles, then each of its halves' selected entries: x times beta for an
    odd half, y negated where the plane says), and the nthr partials join."""
    D, _, Bn = px.shape
    per = 2 * D // nthr
    tab = cuda_msm._tables_plain(px, py, pz, 9)
    planes = dig.reshape(tglv.GLV_WINDOWS, 2 * D, Bn)
    point = torch.arange(2 * D) // 2
    odd = torch.arange(2 * D) % 2 == 1
    acc = tuple(c.clone() for c in tc.identity((nthr, Bn), device="cpu"))
    for w in range(tglv.GLV_WINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = cuda_curve.pt_double_plain(*acc)
        q = cuda_msm._beta_neg(cuda_msm._select_plain(tab, planes[w] & 15, point), odd,
                               (planes[w] >> 4) != 0)  # (16, 2D, B)
        for jj in range(per):
            half = [c[:, jj::per] for c in q]  # half s * per + jj of every slot s
            acc = cuda_curve.pt_add_plain(*acc, *half)
    return join_in_kernel_order(*acc)


def inputs(D, seed):
    """D points and scalars per lane for B = 2 lanes: lane 0 has the scalar
    5 on every point (GLV halves k1 = 5, k2 = 0) and an identity first
    point, lane 1 the scalar lambda (k1 = 0, k2 = 1) on its last point —
    slots whose walks sum nothing hand the join the identity."""
    rng = np.random.default_rng(seed)

    def scalar():
        return int.from_bytes(rng.bytes(40), "big") % N

    pts = [[jc.GENERATOR.mul(scalar()) for _ in range(B)] for _ in range(D)]
    ks = [[scalar() for _ in range(B)] for _ in range(D)]
    for i in range(D):
        ks[i][0] = 5
    pts[0][0] = jc.IDENTITY
    ks[D - 1][1] = tglv.LAMBDA
    want = []
    for b in range(B):
        acc = jc.IDENTITY
        for i in range(D):
            acc = acc.add(pts[i][b].mul(ks[i][b]))
        want.append(acc.to_bytes())
    coords = [torch.from_numpy(np.stack(
        [tf.ints_to_limbs([getattr(p, c) for p in row]) for row in pts], axis=0)) for c in "xyz"]
    sc = torch.from_numpy(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))
    return coords, tglv.wnaf_planes(sc), want


@pytest.mark.parametrize("D, nthr", [(1, 1), (1, 2), (5, 1), (5, 10)])
def test_split_partials_joined_in_kernel_order_give_the_oracle_point(D, nthr):
    """D = 1 and 5 at B = 2, both launches the kernel has (2D threads per
    lane, one half each, and one thread per lane): the joined partials, the
    plain version and the JAX package's oracle agree on every lane."""
    coords, dig, want = inputs(D, 50 + D)
    got = tc.compress(tc.PointJ(*split_walk(*coords, dig, nthr)))
    plain = tc.compress(tc.PointJ(*cuda_msm.msm_small_wnaf_plain(*coords, dig)))
    assert torch.equal(got, plain)
    assert [bytes(got[:, b].tolist()) for b in range(B)] == want

