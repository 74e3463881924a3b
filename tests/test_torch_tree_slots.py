"""K7's decomposition on the CPU: n slots per lane, each summing its
contiguous share of the points with incomplete adds, the partials joined
by `csrc/join.cuh`'s tree of complete adds (`cuda_ladder.tree_sum_slots_plain`,
the kernel's order, which the card holds the kernel to limb for limb),
give the same POINT as the plain sequential chain (`tree_sum_plain`), the
host oracle and the JAX package's `pt_sum`: compressed bytes, tolerance 0.
The edge lanes: all identities, an all-identity slot, a run of points
that sums to the identity, and slots whose partials are equal (a doubling
in the join). `tree_sum_plan` gives a valid launch for every shape the
paths give K7."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu_torch.ops import cuda_curve, cuda_ladder
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import P

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "bppp_tpu_torch", "csrc")
LS = (1, 2, 5, 7, 17, 33)
SLOTS = list(range(1, 9))
B = 4


def lane_points(L, n, seed):
    """rows[l][b] oracle Points, B = 4 lanes of L points, multiples of the
    generator by random 64-bit scalars in random Jacobian representations
    (no relation with small coefficients among them): lane 0 all identities; lane 1 its first ceil(L / 2)
    points the identity (an all-identity slot once n >= 2); lane 2 point 1
    the negative of point 0 (a run that sums to the identity) and its last
    point the identity; lane 3 random, but each slot at least two points
    long and as long as slot 0 under n slots a copy of slot 0's points (equal
    partials: a doubling in the join)."""
    rng = np.random.default_rng(seed)

    def rand():
        q = oc.GENERATOR.mul(int.from_bytes(rng.bytes(8), "big") or 1)
        z = int.from_bytes(rng.bytes(32), "big") % P or 1
        return oc.Point(q.x * z * z % P, q.y * z * z * z % P, q.z * z % P)

    rows = [[rand() for _ in range(B)] for _ in range(L)]
    for l in range(L):
        rows[l][0] = oc.IDENTITY
        if l < (L + 1) // 2:
            rows[l][1] = oc.IDENTITY
    if L > 1:
        p0 = rows[0][2]
        rows[1][2] = oc.Point(p0.x, (P - p0.y) % P, p0.z)
        rows[L - 1][2] = oc.IDENTITY
    bounds = cuda_ladder.slot_bounds(L, n)
    lo0, hi0 = bounds[0]
    if hi0 - lo0 >= 2:
        for lo, hi in bounds[1:]:
            if hi - lo == hi0 - lo0:
                for j in range(hi - lo):
                    rows[lo + j][3] = rows[lo0 + j][3]
    return rows


def grid(rows):
    """rows[l][b] oracle Points -> coords (16, L, B)."""
    return tuple(torch.from_numpy(np.stack(
        [tf.ints_to_limbs([getattr(p, c) for p in row]) for row in rows], axis=1)) for c in "xyz")


def oracle_bytes(rows):
    out = []
    for b in range(B):
        acc = oc.IDENTITY
        for row in rows:
            acc = acc.add(row[b])
        out.append(acc.to_bytes())
    return out


def lane_bytes(xyz):
    c = tc.compress(tc.PointJ(*xyz))
    return [bytes(c[:, j].tolist()) for j in range(c.shape[1])]


_CASES: dict = {}


def cases(L):
    """For each n of SLOTS, the B lanes of `lane_points(L, n)`, side by
    side: (coords (16, L, 8 B), oracle bytes, the sequential chain's
    coords), computed once per L (one eager chain over every n's lanes)."""
    if L not in _CASES:
        per_n = [lane_points(L, n, 100 * L + n) for n in SLOTS]
        rows = [sum((r[l] for r in per_n), []) for l in range(L)]
        p = grid(rows)
        want = sum((oracle_bytes([row[B * i:B * (i + 1)] for row in rows])
                    for i in range(len(SLOTS))), [])
        _CASES[L] = p, want, cuda_ladder.tree_sum_plain(*p)
    return _CASES[L]


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("L", LS)
def test_slots_give_the_sequential_chain_and_the_oracle(L, n):
    """L < n (empty slots), L not a multiple of n, and the edge lanes."""
    p_all, want_all, chain_all = cases(L)
    i = SLOTS.index(n)
    p = tuple(c[..., B * i:B * (i + 1)] for c in p_all)
    got = cuda_ladder.tree_sum_slots_plain(*p, n)
    assert all(c.shape == (16, B) for c in got)
    want = want_all[B * i:B * (i + 1)]
    assert lane_bytes(got) == want
    chain = tuple(c[:, B * i:B * (i + 1)] for c in chain_all)
    assert lane_bytes(chain) == want
    assert bool(tc.pt_is_identity(tc.PointJ(*got))[0])
    if n == 1:  # one slot is the sequential chain, limb for limb
        assert all(torch.equal(a, b) for a, b in zip(got, chain))


def test_slots_and_the_sequential_chain_give_the_jax_pt_sum():
    """Every L of the slot tests at once, the lanes of n = 3 and 8, shorter
    sums padded with the identity to 33 points (one compiled JAX program): the JAX
    package's pt_sum, the sequential chain and the slots at n = 3 and 8
    give the same points."""
    stacks = []
    for L in LS:
        p, _, _ = cases(L)
        pad = tuple(c.new_zeros((16, max(LS) - L, 2 * B)) for c in p)  # (0, 0, 0): the identity
        stacks.append(tuple(torch.cat([c[..., 2 * B:3 * B], c[..., 7 * B:]], dim=2) for c in p))
        stacks[-1] = tuple(torch.cat([c, z], dim=1) for c, z in zip(stacks[-1], pad))
    p = tuple(torch.cat([s[c] for s in stacks], dim=2) for c in range(3))  # (16, 33, 12 B)
    jsum = jax.jit(jc.pt_sum)(jc.PointJ(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p)))
    jgot = jc.compress(jsum)
    jax_bytes = [bytes(col) for col in np.asarray(jgot).astype(np.uint8).T.tolist()]
    assert lane_bytes(cuda_ladder.tree_sum_plain(*p)) == jax_bytes
    for n in (3, 8):
        assert lane_bytes(cuda_ladder.tree_sum_slots_plain(*p, n)) == jax_bytes


def test_slot_mirror_joins_in_the_kernel_order():
    """The join of the mirror is join.cuh's: with slot partials that are
    distinct points, slot s's sum lands in slot 0 through the fixed tree
    (m = 5: 0 += 3, 1 += 4; m = 3: 0 += 2; m = 2: 0 += 1), so every order
    of complete adds gives the same point, and the limbs are those of that
    tree of pt_add_plain calls."""
    rows = lane_points(5, 5, 7)
    p = grid(rows)
    got = cuda_ladder.tree_sum_slots_plain(*p, 5)
    pts = [tuple(c[:, l] for c in p) for l in range(5)]
    add = cuda_curve.pt_add_plain
    s0 = add(*pts[0], *pts[3])
    s1 = add(*pts[1], *pts[4])
    s0 = add(*s0, *pts[2])
    want = add(*s0, *s1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the (L, lanes) pairs the paths give K7 at a batch of 1024: the u64 mirror's
# sum, the WNLA commitments, the WNLA provers' grouped sums (two groups), and
# the kernels phase's ragged row
RECORDED = [(17, 1024), (33, 1024), (65, 1024), (129, 1024), (9, 2048), (17, 2048),
            (33, 2048), (65, 2048), (129, 2048), (7, 93), (17, 16384)]


@pytest.mark.parametrize("L, lanes", RECORDED)
def test_tree_sum_plan_is_a_valid_launch(L, lanes):
    """At least one point per slot, at least one lane per block, the block
    within the kernel's TREE_MAX_THREADS, and lanes per block a divisor of
    a warp or a multiple of one, so a warp's slots read whole runs of
    adjacent lanes."""
    n, lpb = cuda_ladder.tree_sum_plan(L, lanes)
    with open(os.path.join(CSRC, "ladder.cu")) as fh:
        max_threads = int(re.search(r"TREE_MAX_THREADS\s*=\s*(\d+)", fh.read()).group(1))
    assert max_threads == cuda_ladder.K7_BLOCK
    assert 1 <= n <= L and lpb >= 1 and n * lpb <= max_threads
    assert 32 % lpb == 0 or lpb % 32 == 0
    assert cuda_ladder.slot_bounds(L, n)[-1][1] == L
    assert all(hi > lo for lo, hi in cuda_ladder.slot_bounds(L, n))
