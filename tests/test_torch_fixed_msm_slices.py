"""K3's launch decomposition on the CPU: the slice plan the wrapper hands
the fixed-base kernel (`cuda_fixed_base.slice_count` / `slice_bounds`)
covers every (generator, window) term once, summing the plain per-term
entries slice by slice and joining them in the kernel's order
(`csrc/fixed_msm.cu`, `csrc/join.cuh`) gives the plain version's point,
and a row view of the table gives what a copied subset gave and the JAX
package's oracle sum. Every comparison is exact
(tolerance 0): compressed bytes, since the join changes (X, Y, Z) and not
the point."""

import numpy as np
import pytest
import torch

from bppp_tpu.oracle import curve as joc
from bppp_tpu_torch.ops import cuda_curve
from bppp_tpu_torch.ops import cuda_fixed_base as cfb
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

rng = np.random.default_rng(4404)
NW8 = cfb.n_windows(8)  # the default width's 32 windows
H100_SMS = 132


def rand_scalar():
    return int.from_bytes(rng.bytes(40), "big") % N


def scalars(F, B):
    """(16, F, B) limbs from the seed: lane 0 all zero (every slice of it
    sums nothing), lane 1 one live generator, the rest uniform."""
    ks = [[rand_scalar() for _ in range(B)] for _ in range(F)]
    for f in range(F):
        ks[f][0] = 0
        if f:
            ks[f][1] = 0
    return ks, torch.from_numpy(np.stack([tf.ints_to_limbs(r) for r in ks], axis=1))


@pytest.mark.parametrize("F", [2, 17, 49, 129])
@pytest.mark.parametrize("B", [1, 3, 1024, 16384])
def test_slice_plan_covers_every_term_once(B, F):
    """S is a power of two, the bounds tile [0, F * NW) in order without gap
    or overlap, and at B = 1024 the walk's grid covers the whole card."""
    S = cfb.slice_count(B, F, NW8)
    assert S >= 1 and S & (S - 1) == 0 and S <= cfb.MAX_SLICES
    bounds = cfb.slice_bounds(F * NW8, S)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == F * NW8
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo >= cfb.MIN_TERMS for lo, hi in bounds)
    covered = np.zeros(F * NW8, dtype=int)
    for lo, hi in bounds:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    blocks = -(-B // 32) * (S // min(S, 4))  # the walk's grid
    if B <= 1024:  # few lanes: as many slices as the terms allow
        assert S == min(cfb.MAX_SLICES, F * NW8 // cfb.MIN_TERMS)
    if B == 1024 and F == 49:
        assert blocks >= H100_SMS
    if B == 16384:
        assert S <= 8  # the card is full: few extra threads per lane
    assert B * S <= 2 * cfb.RESIDENT_THREADS or S == 1


def join_in_kernel_order(parts):
    """parts: three (16, n, B) partial sums of n slots -> slot 0's total,
    joined as `csrc/join.cuh` joins them: while m > 1, h = ceil(m / 2) and
    slot s < m - h adds slot s + h."""
    x, y, z = (c.clone() for c in parts)
    m = x.shape[1]
    while m > 1:
        h = (m + 1) // 2
        k = m - h
        s = cuda_curve.pt_add_plain(x[:, :k], y[:, :k], z[:, :k],
                                    x[:, h:m], y[:, h:m], z[:, h:m])
        x[:, :k], y[:, :k], z[:, :k] = s
        m = h
    return x[:, 0], y[:, 0], z[:, 0]


def sliced_sum(tab, sc, S):
    """The kernels' decomposition in plain PyTorch: slice s sums the terms
    of `slice_bounds` in order; the join gives a lane n = min(S, 8) slots,
    slot t summing the partials t, t + n, ... in order before the slots
    join in shared memory."""
    NW, F, B = tab.n_windows, tab.n_points, sc.shape[2]
    dig = cfb._digits(sc, tab.w_bits)  # (NW, F, B)
    tx, ty = cfb.table_affine(tab)
    if tab.rows is not None:
        tx, ty = tx[:, :, tab.rows.long()], ty[:, :, tab.rows.long()]
    idx = dig[None].expand(16, NW, F, B)
    # term t = f * NW + w
    qx = torch.gather(tx, 3, idx).permute(0, 2, 1, 3).reshape(16, F * NW, B)
    qy = torch.gather(ty, 3, idx).permute(0, 2, 1, 3).reshape(16, F * NW, B)
    live = (dig != 0).permute(1, 0, 2).reshape(F * NW, B)
    one = torch.zeros_like(qx)
    one[0] = 1
    qz = torch.where(live, one, 0)  # a zero digit is the identity (0, 1, 0)
    qy = torch.where(live, qy, one)
    acc = [c.clone() for c in tc.identity((S, B), device="cpu")]
    bounds = cfb.slice_bounds(F * NW, S)
    for step in range(max(hi - lo for lo, hi in bounds)):
        ts = torch.tensor([min(lo + step, hi - 1) for lo, hi in bounds])
        on = torch.tensor([lo + step < hi for lo, hi in bounds])[:, None]
        s = cuda_curve.pt_add_plain(*acc, qx[:, ts], qy[:, ts], qz[:, ts])
        acc = [torch.where(on, a, b) for a, b in zip(s, acc)]
    if S == 1:
        return tuple(c[:, 0] for c in acc)
    n = min(S, cfb.JOIN_SLOTS)
    slots = []
    for t in range(n):
        run = tc.identity((B,), device="cpu")
        for g in range(t, S, n):
            run = cuda_curve.pt_add_plain(*run, *(c[:, g] for c in acc))
        slots.append(run)
    return join_in_kernel_order([torch.stack([r[c] for r in slots], dim=1) for c in range(3)])


def oracle_tables(gens, w_bits):
    """`build_tables`' layout made from the oracle's affine points (its
    eager build over 49 generators costs minutes on a CPU; the entries are
    held against the oracle in test_torch_fixed_base.py)."""
    NW, NE = cfb.n_windows(w_bits), 1 << w_bits
    words = np.zeros((NW, len(gens), NE, 16), dtype=np.int64)
    for i, g in enumerate(gens):
        base = g
        for w in range(NW):
            cur = oc.IDENTITY
            for d in range(1, NE):
                cur = cur.add(base)
                x, y = cur.to_affine()
                words[w, i, d] = [(v >> (32 * k)) & 0xFFFFFFFF for v in (x, y) for k in range(8)]
            base = cur.add(base)  # [2^W] base
    words = np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32)
    return cfb.Tables(torch.from_numpy(words), w_bits, {})


GENS = [oc.GENERATOR.mul(rand_scalar()) for _ in range(5)]
KS, SC = scalars(5, 3)


@pytest.fixture(scope="module")
def small():
    """W = 4 tables of 5 generators, and the plain sum of SC over them."""
    tab = oracle_tables(GENS, 4)
    return tab, tc.compress(tc.PointJ(*cfb.fixed_msm_plain(tab, SC)))


@pytest.mark.parametrize("S", [1, 2, 8, 16, 64])
def test_slices_joined_in_kernel_order_give_the_plain_point(small, S):
    """B = 3, F = 5 at W = 4 (320 terms): every slice count the kernels
    take, up to 64 slices joined by 8 slots of 8 partials; lane 0, whose
    slices are all identities, stays the identity."""
    tab, want = small
    got = tc.compress(tc.PointJ(*sliced_sum(tab, SC, S)))
    assert torch.equal(got, want)
    assert int(got[:, 0].abs().sum()) == 0
    for b in range(3):
        acc = oc.IDENTITY
        for g, row in zip(GENS, KS):
            acc = acc.add(g.mul(row[b]))
        assert bytes(want[:, b].tolist()) == acc.to_bytes()


def test_sliced_sum_over_a_row_view(small):
    """The same decomposition through a row index: the point of the
    subset's own sum."""
    view = small[0].subset((4, 1, 2))
    sc = SC[:, :3]
    want = tc.compress(tc.PointJ(*cfb.fixed_msm_plain(view, sc)))
    assert torch.equal(tc.compress(tc.PointJ(*sliced_sum(view, sc, 16))), want)


# -- a prover tuple through the row index ------------------------------------------------

# the u64 generator layout [g | h_vec (32) | g_vec (16)] and the WNLA prover's
# first-round R tuple at the u64 dims: g, the odd positions of the 26 live
# h entries and the odd positions of g_vec (22 rows with gaps between them)
R_TUPLE = (0,) + tuple(2 + 2 * j for j in range(13)) + tuple(34 + 2 * j for j in range(8))
U64_GENS = [oc.GENERATOR.mul(rand_scalar()) for _ in range(49)]


def test_row_index_gives_the_copied_subset_and_the_oracle_point():
    """`fixed_msm_plain` over the R tuple's row view of a 49-row table
    equals the same sum over a copy of those rows (what the prover walked
    before) and the JAX package's oracle, on numpy-seeded scalars; the view
    copies nothing. (The port's `msm_fixed_positions` through a row view
    against the JAX package's own `msm_fixed_positions` is
    test_torch_fixed_base.py::test_msm_fixed_positions_matches_jax: the
    JAX Straus walk costs most of a minute per call here.)"""
    tab = oracle_tables(U64_GENS, 2)
    ks, sc = scalars(len(R_TUPLE), 2)
    view = tab.subset(R_TUPLE)
    assert view.words is tab.words and view.rows.dtype == torch.int32
    assert view.rows.tolist() == list(R_TUPLE) and tab.subset(list(R_TUPLE)) is view
    got = tc.compress(tc.PointJ(*cfb.fixed_msm_plain(view, sc)))
    copy = cfb.Tables(tab.words.index_select(1, torch.tensor(R_TUPLE)).contiguous(),
                      tab.w_bits, {})
    assert torch.equal(got, tc.compress(tc.PointJ(*cfb.fixed_msm_plain(copy, sc))))
    jgens = [joc.Point(g.x, g.y, g.z) for g in U64_GENS]
    for b in range(2):
        acc = joc.IDENTITY
        for p, row in zip(R_TUPLE, ks):
            acc = acc.add(jgens[p].mul(row[b]))
        assert bytes(got[:, b].tolist()) == acc.to_bytes()
