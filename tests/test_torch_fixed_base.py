"""The port's fixed-base tables, window digits and `msm_mixed` (the plain
version of the fixed-base kernel) against the host oracle and the JAX
package. Every comparison is exact (tolerance 0); MSM results are
compared as compressed bytes, since the two packages reach the same POINT
through different sequences of adds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu.ops import fixed_base as jfb
from bppp_tpu.ops import pallas_fixed_base as jpfb
from bppp_tpu_torch.ops import cuda_fixed_base as cfb
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import fixed_base as fb
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N

rng = np.random.default_rng(777)


def rand_scalar():
    return int.from_bytes(rng.bytes(40), "big") % N


GENS = [oc.GENERATOR.mul(rand_scalar()) for _ in range(3)]
DYN = [oc.GENERATOR.mul(rand_scalar()) for _ in range(2)]
_TABLES = {}


def tables(w_bits):
    if w_bits not in _TABLES:
        _TABLES[w_bits] = fb.build_tables(tc.from_int_points(GENS, device="cpu"), w_bits)
    return _TABLES[w_bits]


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def affine(p):
    b = p.to_bytes()
    return int.from_bytes(b[1:], "big"), b[0] & 1


@pytest.mark.parametrize("w_bits", [4, 8])
def test_build_tables_entries(w_bits):
    """Every entry [d * 2^(w*W)] G_i against oracle multiples: all digits
    of three windows (first, a middle one, last), entry 0 the all-zero
    identity sentinel everywhere."""
    tab = tables(w_bits)
    NW, NE = cfb.n_windows(w_bits), 1 << w_bits
    assert tab.words.shape == (NW, 3, NE, 16) and tab.words.dtype == torch.int32
    assert tab.w_bits == w_bits and tab.n_windows == NW and tab.n_points == 3
    assert int(tab.words[:, :, 0].abs().sum()) == 0
    tx, ty = cfb.table_affine(tab)  # (16, NW, F, NE)
    for w in (0, NW // 2, NW - 1):
        for i, g in enumerate(GENS):
            base = g.mul(1 << (w * w_bits))
            cur = oc.IDENTITY
            xs = tf.limbs_to_ints(tx[:, w, i])
            ys = tf.limbs_to_ints(ty[:, w, i])
            for d in range(1, NE):
                cur = cur.add(base)
                x, parity = affine(cur)
                assert xs[d] == x and ys[d] & 1 == parity, (w, i, d)


def test_tables_subset_and_bad_width():
    tab = tables(4)
    sub = tab.take([0, 2])  # a row view: the same words, nothing copied
    assert sub.n_points == 2 and sub.words is tab.words and sub.rows.tolist() == [0, 2]
    assert sub.rows.dtype == torch.int32 and sub.take([1]).rows.tolist() == [2]
    with pytest.raises(ValueError):
        tab.take([0, 3])
    with pytest.raises(ValueError):
        fb.build_tables(tc.from_int_points(GENS, device="cpu"), 0)
    with pytest.raises(ValueError):
        cfb.fixed_msm(tab, torch.zeros((16, 2, 3), dtype=torch.int64))


@pytest.mark.parametrize("w_bits", [2, 4, 5, 8, 10, 11, 16])
def test_window_digits(w_bits):
    ks = [0, 1, N - 1, (1 << 256) - 1] + [rand_scalar() for _ in range(4)]
    sc = T(tf.ints_to_limbs(ks)).reshape(16, 2, 4)
    dig = fb._digits(sc, w_bits)
    NW = cfb.n_windows(w_bits)
    assert dig.shape == (NW, 2, 4)
    flat = dig.reshape(NW, 8)
    for j, k in enumerate(ks):
        assert flat[:, j].tolist() == [
            (k >> (w_bits * w)) & ((1 << w_bits) - 1) for w in range(NW)
        ]
    if w_bits == jpfb.W_BITS:  # the JAX package's width is fixed at import
        want = jpfb._digits(jnp.asarray(sc.numpy().astype(np.uint32)))
        assert np.array_equal(dig.numpy(), np.asarray(want).astype(np.int64))


def _mixed_inputs(B=2):
    fks = [[rand_scalar() for _ in range(B)] for _ in GENS]
    dks = [[rand_scalar() for _ in range(B)] for _ in DYN]
    fks[0][0] = 0
    dks[1][1] = 0
    fixed_pts = tc.from_int_points(GENS, batch=(B,), device="cpu")
    dyn_pts = tc.from_int_points(DYN, batch=(B,), device="cpu")
    fsc = T(np.stack([tf.ints_to_limbs(r) for r in fks], axis=1))
    dsc = T(np.stack([tf.ints_to_limbs(r) for r in dks], axis=1))
    want = []
    for b in range(B):
        acc = oc.IDENTITY
        for g, r in zip(GENS + DYN, fks + dks):
            acc = acc.add(g.mul(r[b]))
        want.append(acc.to_bytes())
    return fixed_pts, fsc, dyn_pts, dsc, want


MIXED = _mixed_inputs()


@pytest.mark.parametrize("w_bits", [None, 4, 8], ids=["no_tables", "W4", "W8"])
def test_msm_mixed_matches_oracle(w_bits):
    fixed_pts, fsc, dyn_pts, dsc, want = MIXED
    tab = tables(w_bits) if w_bits else None
    got = tc.compress(fb.msm_mixed(tab, fixed_pts, fsc, dyn_pts, dsc))
    assert [bytes(got[:, b].tolist()) for b in range(2)] == want


def test_msm_mixed_matches_jax():
    fixed_pts, fsc, dyn_pts, dsc, want = MIXED
    J = lambda a: jnp.asarray(a.numpy().astype(np.uint32))
    jgot = jc.compress(
        jfb.msm_mixed(
            None,
            jc.PointJ(*(J(c) for c in fixed_pts)), J(fsc),
            jc.PointJ(*(J(c) for c in dyn_pts)), J(dsc),
        )
    )
    assert [bytes(np.asarray(jgot)[:, b].astype(np.uint8).tolist()) for b in range(2)] == want
    got = tc.compress(fb.msm_mixed(tables(4), fixed_pts, fsc, dyn_pts, dsc))
    assert np.array_equal(got.numpy(), np.asarray(jgot).astype(np.int64))


def test_fixed_msm_zero_scalars_give_identity():
    tab = tables(4)
    out = tc.PointJ(*cfb.fixed_msm(tab, torch.zeros((16, 3, 2), dtype=torch.int64)))
    assert tc.pt_is_identity(out).all()
    assert int(tc.compress(out).abs().sum()) == 0


# -- the prover's entry points: a static subset of the table rows, or all of them --


def _subset_inputs(B=2, lead=None):
    """Scalars (16, P, *lead, B) for the positions (2, 0) of GENS, and the
    oracle's sums per (lead, lane)."""
    shape = ((lead,) if lead else ()) + (B,)
    count = int(np.prod(shape))
    ks = [[rand_scalar() for _ in range(count)] for _ in range(2)]
    ks[0][0] = 0
    sc = T(np.stack([tf.ints_to_limbs(r) for r in ks], axis=1)).reshape((16, 2) + shape)
    want = [GENS[2].mul(ks[0][j]).add(GENS[0].mul(ks[1][j])).to_bytes() for j in range(count)]
    return sc, want


SUBSET = _subset_inputs()


@pytest.mark.parametrize("w_bits", [None, 4], ids=["no_tables", "W4"])
def test_msm_fixed_positions_matches_oracle(w_bits):
    """sum_j [s_j] G_positions[j] for positions (2, 0): scalars in POSITION
    order, with tables (only those rows are walked) and without."""
    sc, want = SUBSET
    tab = tables(w_bits) if w_bits else None
    pts = tc.from_int_points(GENS, batch=(2,), device="cpu")
    got = tc.compress(fb.msm_fixed_positions(tab, pts, (2, 0), sc))
    assert [bytes(got[:, b].tolist()) for b in range(2)] == want
    with pytest.raises(ValueError):
        fb.msm_fixed_positions(tab, pts, (2, 0, 1), sc)


def test_table_subsets_are_built_once_and_kept():
    tab = fb.build_tables(tc.from_int_points(GENS, device="cpu"), 2)
    assert tab.subsets == {}
    first = tab.subset((2, 0))
    assert tab.subset([2, 0]) is first and list(tab.subsets) == [(2, 0)]
    assert first.n_points == 2 and first.words is tab.words and first.rows.tolist() == [2, 0]
    assert tab.subset((0,)) is not first and len(tab.subsets) == 2


def test_fixed_msms_flatten_leading_batch_axes():
    """Several MSMs stacked on a leading batch axis ride one call: with
    tables the axes flatten into lanes, without them the generators
    broadcast over the extra axis."""
    sc, want = _subset_inputs(B=2, lead=3)  # (16, 2, 3, 2)
    pts = tc.from_int_points(GENS, batch=(2,), device="cpu")  # (16, 3, 2)
    for tab in (tables(4), None):
        got = fb.msm_fixed_positions(tab, pts, (2, 0), sc)
        assert got.x.shape == (16, 3, 2)
        flat = tc.compress(got).reshape(33, 6)
        assert [bytes(flat[:, j].tolist()) for j in range(6)] == want


@pytest.mark.parametrize("w_bits", [None, 4], ids=["no_tables", "W4"])
def test_msm_fixed_total_matches_oracle(w_bits):
    fixed_pts, fsc, _, _, _ = MIXED
    tab = tables(w_bits) if w_bits else None
    got = tc.compress(fb.msm_fixed_total(tab, fixed_pts, fsc))
    ks = [tf.limbs_to_ints(fsc[:, i]) for i in range(3)]
    for b in range(2):
        acc = oc.IDENTITY
        for g, row in zip(GENS, ks):
            acc = acc.add(g.mul(row[b]))
        assert bytes(got[:, b].tolist()) == acc.to_bytes()


def test_msm_fixed_positions_matches_jax():
    """The JAX package's `msm_fixed_positions` (its table-less route, called
    un-jitted) on the same inputs: the same points. Its `msm_fixed_total`
    is the same Straus walk over all rows; the port's is held against the
    oracle above."""
    sc, _ = SUBSET
    fixed_pts = MIXED[0]
    J = lambda a: jnp.asarray(a.numpy().astype(np.uint32))
    jpts = jc.PointJ(*(J(c) for c in fixed_pts))
    jpos = jc.compress(jfb.msm_fixed_positions(None, jpts, (2, 0), J(sc)))
    got = tc.compress(fb.msm_fixed_positions(tables(4), fixed_pts, (2, 0), sc))
    assert np.array_equal(got.numpy(), np.asarray(jpos).astype(np.int64))
