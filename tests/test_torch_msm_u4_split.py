"""K8's and K9's launch decomposition on the CPU: the wrappers' plans
(`cuda_msm.msm_small_glv_plan`, `msm_small_plan`) give each lane several
threads, each walking one GLV half (K8) or one point (K9) over its
point's table, and the per-thread partial sums joined in the kernels'
order (`csrc/msm_small_u4.cu`, `csrc/join.cuh`) give the plain version's
point and the JAX package's oracle sum. Every comparison is exact
(tolerance 0): compressed bytes, since the split changes (X, Y, Z) and not
the point."""

import numpy as np
import pytest
import torch

from bppp_tpu.oracle import curve as jc
from bppp_tpu_torch.ops import cuda_curve, cuda_ladder, cuda_msm
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv as tglv
from bppp_tpu_torch.oracle.field import N
from test_torch_msm_small_split import join_in_kernel_order

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

KERNELS = ("msm_small_glv", "msm_small")
PLANS = {"msm_small_glv": cuda_msm.msm_small_glv_plan, "msm_small": cuda_msm.msm_small_plan}
SMEM = {"msm_small_glv": cuda_msm.k8_smem_bytes, "msm_small": cuda_msm.k9_smem_bytes}
# where one thread per lane won the sweep of both launches on the H100
# (tools/compare_designs.py, PERF.md): (kernel, D, lanes)
LANE_WALK_WON = {("msm_small_glv", 2, 16384), ("msm_small_glv", 3, 16384)}


@pytest.mark.parametrize("B_", [1, 70, 77, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plan_splits_lanes_up_to_the_measured_threshold(kernel, D, B_):
    """K8: 2D threads per lane (one GLV half each) while the launch's
    threads stay within K8_SPLIT_THREADS, one thread per lane beyond; K9:
    D threads per lane (one point each) at any B, since its split won at
    every lane count swept. At every swept lane count the plan takes the
    launch that won. A block fits U4_BLOCK threads."""
    nthr, lpb = PLANS[kernel](D, B_)
    if kernel == "msm_small_glv":
        split = 2 * D
        assert nthr == (split if split * B_ <= cuda_msm.K8_SPLIT_THREADS else 1)
    else:
        split = D
        assert nthr == split
    assert 1 <= lpb and nthr * lpb <= cuda_msm.U4_BLOCK
    assert lpb == (cuda_msm.U4_BLOCK // split if nthr == split else cuda_msm.U4_LANE_BLOCK)
    if B_ >= 1024:
        assert (nthr == 1 < split) == ((kernel, D, B_) in LANE_WALK_WON)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("D", [1, 2, 3])
def test_split_tables_and_join_fit_shared_memory(kernel, D):
    """The split's shared memory — K8's tables [1..15] P_i of every lane of
    a block and its join's partials, K9's join (its tables sit in each
    thread's own array) — fits what a block may opt into, at the plan's
    lanes per block and at any block of up to U4_BLOCK threads."""
    nthr, lpb = PLANS[kernel](D, 1024)
    assert SMEM[kernel](D, lpb) <= cuda_msm.U4_SMEM
    assert SMEM[kernel](D, cuda_msm.U4_BLOCK // nthr) <= cuda_msm.U4_SMEM
    tables = D * 15 * 24 if kernel == "msm_small_glv" else 0
    assert SMEM[kernel](D, 1) == 4 * (tables + 24 * (nthr // 2))


def slot_walks(tab, digit, point, n_windows):
    """One partial per slot, as the kernels walk: slot s over the table of
    point point[s], windows MSB first, 4 doubles per window (none before
    the first), then an incomplete add of entry digit(w)[s] (entry 0 is
    the identity, which the add passes through). -> three (16, S, B)."""
    S = point.shape[0]
    B_ = tab[0].shape[-1]
    acc = tuple(c.clone() for c in tc.identity((S, B_), device="cpu"))
    for w in range(n_windows - 1, -1, -1):
        if w != n_windows - 1:
            for _ in range(4):
                acc = cuda_curve.pt_double_plain(*acc)
        acc = cuda_ladder.pt_add_inc_plain(*acc, *cuda_msm._select_plain(tab, digit(w), point))
    return acc


def k8_split(px, py, pz, mags, signs):
    """K8's decomposition: slot j walks half j of point j / 2 over the
    plain table, then x times beta for an odd slot and y negated where the
    half is negative, once; the 2D partials join."""
    D = px.shape[0]
    tab = cuda_msm._tables_plain(px, py, pz, 16)
    mm = mags.movedim(0, 1)  # (16, 2D, B)
    part = slot_walks(tab, lambda w: (mm[w // 4] >> (4 * (w % 4))) & 15,
                      torch.arange(2 * D) // 2, tglv.GLV_WINDOWS)
    part = cuda_msm._beta_neg(part, torch.arange(2 * D) % 2 == 1, signs != 0)
    return join_in_kernel_order(*part)


def k9_split(px, py, pz, k):
    """K9's decomposition: slot i walks the 64 windows of point i's
    scalar; the D partials join."""
    D = px.shape[0]
    tab = cuda_msm._tables_plain(px, py, pz, 16)
    kk = k.movedim(0, 1)  # (16, D, B)
    part = slot_walks(tab, lambda w: (kk[w // 4] >> (4 * (w % 4))) & 15, torch.arange(D), 64)
    return join_in_kernel_order(*part)


def inputs(D, seed):
    """D points and scalars per lane for 4 lanes, scalars by lane and point
    from the rows below (point i takes column i): lane 0 an identity first
    point, lane 1 identity points only, lane 2 the scalar lambda on every
    point (GLV halves k1 = 0, k2 = 1); the scalars 5 (k2 = 0), n - 1 (a
    negative k1) and 0 on lanes 0, 1 and 3. Slots whose walks sum nothing
    hand the join the identity."""
    rng = np.random.default_rng(seed)

    def scalar():
        return int.from_bytes(rng.bytes(40), "big") % N

    lam = tglv.LAMBDA
    rows = [[5, scalar(), lam], [lam, N - 1, 5], [lam, lam, lam], [N - 1, 0, scalar()]]
    B_ = len(rows)
    pts = [[jc.GENERATOR.mul(scalar()) for _ in range(B_)] for _ in range(D)]
    ks = [[rows[b][i] for b in range(B_)] for i in range(D)]
    pts[0][0] = jc.IDENTITY
    for i in range(D):
        pts[i][1] = jc.IDENTITY
    want = []
    for b in range(B_):
        acc = jc.IDENTITY
        for i in range(D):
            acc = acc.add(pts[i][b].mul(ks[i][b]))
        want.append(acc.to_bytes())
    coords = [torch.from_numpy(np.stack(
        [tf.ints_to_limbs([getattr(p, c) for p in row]) for row in pts], axis=0)) for c in "xyz"]
    sc = torch.from_numpy(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))  # (16, D, B)
    return coords, sc, want


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("kernel", KERNELS)
def test_split_partials_joined_in_kernel_order_give_the_oracle_point(kernel, D):
    """D = 1..3 on 4 edge lanes: the joined partials, the plain version
    and the JAX package's oracle agree on every lane."""
    coords, sc, want = inputs(D, 60 + D)
    if kernel == "msm_small_glv":
        mags, signs = tglv.glv_halves(sc)
        assert bool(signs[0, 3] != 0)  # n - 1: a negative k1
        got = k8_split(*coords, mags, signs)
        plain = cuda_msm.msm_small_glv_plain(*coords, mags, signs)
    else:
        k = sc.movedim(1, 0).contiguous()
        got = k9_split(*coords, k)
        plain = cuda_msm.msm_small_plain(*coords, k)
    got = tc.compress(tc.PointJ(*got))
    assert torch.equal(got, tc.compress(tc.PointJ(*plain)))
    assert [bytes(got[:, b].tolist()) for b in range(got.shape[1])] == want
