"""The port's weight-norm linear argument beyond the collapsed verifier:
`commit`, `_fold_public`, the mirror `verify`, the mirror and the fast
prover, and `verify_fast` / `prove` giving way to the mirror versions at
sizes the fast path does not take — against the host oracle, the frozen
vector tests/fixtures/wnla_proof.json and the JAX package (called op by
op, un-jitted). Every comparison is exact (tolerance 0): limbs for scalars
and for points that both packages reach by the same adds, compressed
bytes otherwise."""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu.protocol.wnla import WNLADevice as JaxWNLA
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import fixed_base as fb
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle import serde
from bppp_tpu_torch.oracle.field import N, fn_mul
from bppp_tpu_torch.oracle.merlin import Transcript as HostTranscript
from bppp_tpu_torch.oracle.wnla import WNLA
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol.wnla import WNLADevice, num_rounds
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import SeededRng

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

LABEL = b"wnla test"
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
B = 2


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def J(a):
    return jnp.asarray(a.numpy().astype(np.uint32))


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


class Instance:
    """An oracle WNLA per lane over shared generators, and the batched
    device instance of the same data."""

    def __init__(self, seed, lh, lg, witnesses=None, tables=None):
        rng = SeededRng(seed)
        self.g = oc.GENERATOR.mul(rng.scalar())
        self.g_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(lg)]
        self.h_vec = [oc.GENERATOR.mul(rng.scalar()) for _ in range(lh)]
        self.lanes = []
        for b in range(B):
            c = rng.scalars(lh)
            rho = rng.scalar()
            if witnesses is not None and b < len(witnesses):
                l, n = witnesses[b]
            else:
                l, n = rng.scalars(lh), rng.scalars(lg)
            w = WNLA(g=self.g, g_vec=self.g_vec, h_vec=self.h_vec, c=c, rho=rho,
                     mu=fn_mul(rho, rho))
            self.lanes.append(dict(w=w, l=l, n=n, com=w.commit(l, n)))
        w_bits = tables
        tab = None
        if w_bits:
            tab = fb.build_tables(
                tc.from_int_points([self.g] + self.h_vec + self.g_vec, device="cpu"), w_bits)
        self.dev = WNLADevice(
            g=cv.point_batched(self.g, B, device="cpu"),
            g_vec=cv.points_batched(self.g_vec, B, device="cpu"),
            h_vec=cv.points_batched(self.h_vec, B, device="cpu"),
            c_vec=T(cv.scalar_cols([ln["w"].c for ln in self.lanes])),
            rho=T(tf.ints_to_limbs([ln["w"].rho for ln in self.lanes])),
            mu=T(tf.ints_to_limbs([ln["w"].mu for ln in self.lanes])),
            tables=tab,
        )
        self.l = T(cv.scalar_cols([ln["l"] for ln in self.lanes]))
        self.n = T(cv.scalar_cols([ln["n"] for ln in self.lanes]))
        self.com = tc.from_int_points([ln["com"] for ln in self.lanes], device="cpu")  # (16, B)

    def oracle_proofs(self):
        out = []
        for ln in self.lanes:
            proof = ln["w"].prove(ln["com"], HostTranscript(LABEL), ln["l"], ln["n"])
            assert ln["w"].verify(ln["com"], HostTranscript(LABEL), proof)
            out.append(proof)
        return out

    def transcript(self):
        return Transcript(LABEL, batch=(B,), device="cpu")

    def jax(self):
        d = self.dev
        to_j = lambda p: jc.PointJ(*(J(c) for c in p))
        return JaxWNLA(to_j(d.g), to_j(d.g_vec), to_j(d.h_vec), J(d.c), J(d.rho), J(d.mu))


def proof_bytes(proof):
    return dict(
        r=[p.to_bytes() for p in proof.r], x=[p.to_bytes() for p in proof.x],
        l=list(proof.l), n=list(proof.n),
    )


@pytest.fixture(scope="module")
def frozen():
    """The instance of tests/fixtures/wnla_proof.json in lane 0 (seeded
    generators, l = [1, 2, 3, 4], n = [8, 7, 6, 5]); lane 1 has a witness of
    its own. Sizes (4, 4): one folding round."""
    with open(os.path.join(FIX, "wnla_proof.json")) as fh:
        fx = json.load(fh)
    inst = Instance(fx["seed"], 4, 4, witnesses=[([1, 2, 3, 4], [8, 7, 6, 5])])
    assert serde.point_to_hex(inst.lanes[0]["com"]) == fx["commitment"]
    return fx, inst


# -- commitments and the public fold ------------------------------------------------


def test_commit_value_and_commit_match_oracle(frozen):
    _, inst = frozen
    v = inst.dev.commit_value(inst.l, inst.n)
    for b, ln in enumerate(inst.lanes):
        want = (sum(c * l for c, l in zip(ln["w"].c, ln["l"]))
                + sum(a * a * pow(ln["w"].mu, i + 1, N) for i, a in enumerate(ln["n"]))) % N
        assert cv.scalar_lane(v, b) == want
    got = tc.compress(inst.dev.commit(inst.l, inst.n))  # 9 points: ladder + sum
    assert [bytes(got[:, b].tolist()) for b in range(B)] == [
        ln["com"].to_bytes() for ln in inst.lanes]


def test_fold_public_and_commit_value_match_jax():
    """One public fold of a (4, 2) instance, step for step beside the JAX
    package: the folded generators agree limb for limb (same ladder, same
    complete adds), and so do the folded scalars and the commitment value
    over the folded instance. (The commitment POINT is held against the
    oracle above: the JAX package's `commit`, run op by op, costs another
    minute of XLA compiles.)"""
    inst = Instance("fold public", 4, 2)
    y = T(tf.ints_to_limbs([int.from_bytes(b"\x07" * 31, "big"), N - 2]))
    mine = inst.dev._fold_public(y)
    theirs = inst.jax()._fold_public(J(y))
    assert mine.h_vec.x.shape == (16, 2, B) and mine.g_vec.x.shape == (16, 1, B)
    for a, b in zip(mine.h_vec + mine.g_vec, theirs.h_vec + theirs.g_vec):
        assert same(a, b)
    assert same(mine.c, theirs.c) and same(mine.rho, theirs.rho) and same(mine.mu, theirs.mu)
    l, n = inst.l[:, :2], inst.n[:, :1]
    assert same(mine.commit_value(l, n), theirs.commit_value(J(l), J(n)))


def test_fold_public_matches_oracle_generators(frozen):
    _, inst = frozen
    ys = [5, N - 3]
    cur = inst.dev._fold_public(T(tf.ints_to_limbs(ys)))
    for b, ln in enumerate(inst.lanes):
        w = ln["w"]
        h = [w.h_vec[2 * i].add(w.h_vec[2 * i + 1].mul(ys[b])) for i in range(2)]
        g = [w.g_vec[2 * i].mul(w.rho).add(w.g_vec[2 * i + 1].mul(ys[b])) for i in range(2)]
        assert [p.to_bytes() for p in cv.point_vec_lane(cur.h_vec, b)] == [p.to_bytes() for p in h]
        assert [p.to_bytes() for p in cv.point_vec_lane(cur.g_vec, b)] == [p.to_bytes() for p in g]
        assert cv.scalar_lane(cur.rho, b) == w.mu and cv.scalar_lane(cur.mu, b) == fn_mul(w.mu, w.mu)


# -- the mirror verifier ------------------------------------------------------------


@pytest.fixture(scope="module")
def frozen_masks(frozen):
    """ONE mirror `verify` call over four pairs of lanes: the frozen proof
    and lane 1's oracle proof as they are, then with a scalar, an X byte
    and the commitment tampered in one lane of the pair."""
    fx, inst = frozen
    loaded = serde.wnla_proof_from_dict(fx["proof"])
    pb = cv.wnla_proofs_to_bytes([loaded, inst.oracle_proofs()[1]], device="cpu")
    cases = {"valid": (pb, inst.com, [True, True])}
    bad = pb.l.clone(); bad[0, 1, 0] = (bad[0, 1, 0] + 1) % (1 << 16)
    cases["tampered_l"] = (pb._replace(l=bad), inst.com, [False, True])
    bad = pb.x.clone(); bad[7, 0, 1] ^= 0x20
    cases["tampered_x"] = (pb._replace(x=bad), inst.com, [True, False])
    swapped = tc.PointJ(*(c.flip(1) for c in inst.com))
    cases["wrong_commitment"] = (pb, swapped, [False, False])
    names = sorted(cases)
    cat = lambda ts: torch.cat(ts, dim=-1)
    big_pb = type(pb)(*(cat([cases[n][0][i] for n in names]) for i in range(4)))
    big_com = tc.PointJ(*(cat([cases[n][1][i] for n in names]) for i in range(3)))
    d = inst.dev
    rep = lambda t: t.repeat((1,) * (t.ndim - 1) + (len(names),))
    big = WNLADevice(
        g=tc.PointJ(*(rep(c) for c in d.g)), g_vec=tc.PointJ(*(rep(c) for c in d.g_vec)),
        h_vec=tc.PointJ(*(rep(c) for c in d.h_vec)), c_vec=rep(d.c), rho=rep(d.rho), mu=rep(d.mu),
    )
    t = Transcript(LABEL, batch=(B * len(names),), device="cpu")
    ok = big.verify(big_com, t, big_pb)
    assert ok.dtype == torch.bool and ok.shape == (B * len(names),)
    return {n: (ok[2 * i : 2 * i + 2].tolist(), cases[n][2]) for i, n in enumerate(names)}


@pytest.mark.parametrize("name", ["tampered_l", "tampered_x", "valid", "wrong_commitment"])
def test_mirror_verify_frozen_vector(frozen_masks, name):
    got, want = frozen_masks[name]
    assert got == want


# -- the provers --------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_rounds():
    """Sizes (8, 4): two folding rounds, divisible by 2^2, so `prove` takes
    the fast prover. -> (instance, oracle proofs, fast proof, mirror proof)."""
    inst = Instance("two rounds", 8, 4)
    assert num_rounds(8, 4) == 2
    fast = inst.dev.prove(inst.com, inst.transcript(), inst.l, inst.n)
    mirror = inst.dev._prove_mirror(inst.com, inst.transcript(), inst.l, inst.n, 2)
    return inst, inst.oracle_proofs(), fast, mirror


@pytest.mark.parametrize("which", ["fast", "mirror"])
@pytest.mark.parametrize("lane", range(B))
def test_prover_bytes_equal_oracle(two_rounds, which, lane):
    _, oracle, fast, mirror = two_rounds
    got = cv.wnla_dev_to_oracle(fast if which == "fast" else mirror, lane)
    assert proof_bytes(got) == proof_bytes(oracle[lane])


def test_fast_and_mirror_provers_agree(two_rounds):
    _, _, fast, mirror = two_rounds
    a, b = cv.wnla_dev_to_bytes(fast), cv.wnla_dev_to_bytes(mirror)
    assert a.r.shape == (33, 2, B) and a.l.shape == (16, 2, B) and a.n.shape == (16, 1, B)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_both_verifiers_accept_the_ports_proof(two_rounds):
    inst, _, fast, _ = two_rounds
    pb = cv.wnla_dev_to_bytes(fast)
    bad = pb.n.clone(); bad[0, 0, 1] ^= 1
    pb = pb._replace(n=bad)
    assert inst.dev.verify(inst.com, inst.transcript(), pb).tolist() == [True, False]
    assert inst.dev.verify_fast(inst.com, inst.transcript(), pb).tolist() == [True, False]


def test_fast_prover_with_tables_and_zero_tail():
    """Window tables present and a witness whose tail is zero, at sizes
    (4, 2): the fast prover walks fewer table rows (5 of 7 for X, 3 for R)
    and gives the oracle's bytes; a tail that is not zero trips the debug
    check."""
    zl = 2
    inst = Instance("zero tail", 4, 2, tables=4)
    l = inst.l.clone(); l[:, 4 - zl :] = 0
    com = inst.dev.commit(l, inst.n)
    proof = inst.dev.prove(com, inst.transcript(), l, inst.n, zero_tail=(zl, 0))
    assert sorted(inst.dev.tables.subsets) == [(0, 1, 2, 5, 6), (0, 2, 6)]
    for b, ln in enumerate(inst.lanes):
        lo = ln["l"][: 4 - zl] + [0] * zl
        c = ln["w"].commit(lo, ln["n"])
        assert cv.point_lane(com, b).to_bytes() == c.to_bytes()
        want = ln["w"].prove(c, HostTranscript(LABEL), lo, ln["n"])
        assert proof_bytes(cv.wnla_dev_to_oracle(proof, b)) == proof_bytes(want)
    with pytest.raises(AssertionError, match="zero_tail"):
        inst.dev.prove(inst.com, inst.transcript(), inst.l, inst.n, zero_tail=(zl, 0))


# -- sizes the fast path gives way on -------------------------------------------------


def test_odd_sizes_give_way_to_the_mirror_versions():
    """(5, 4): one round, 5 not divisible by 2. `prove` and `verify_fast`
    warn and run the mirror versions; proof bytes equal the oracle's."""
    inst = Instance("odd sizes", 5, 4)
    assert num_rounds(5, 4) == 1
    oracle = inst.oracle_proofs()
    with pytest.warns(UserWarning, match="mirror prover"):
        proof = inst.dev.prove(inst.com, inst.transcript(), inst.l, inst.n)
    for b in range(B):
        assert proof_bytes(cv.wnla_dev_to_oracle(proof, b)) == proof_bytes(oracle[b])
    pb = cv.wnla_proofs_to_bytes(oracle, device="cpu")
    bad = pb.r.clone(); bad[9, 0, 0] ^= 4
    with pytest.warns(UserWarning, match="mirror verifier"):
        ok = inst.dev.verify_fast(inst.com, inst.transcript(), pb._replace(r=bad))
    assert ok.tolist() == [False, True]


def test_zero_rounds_verify_fast_is_the_mirror_verifier():
    """(2, 2): no folding round; the proof is the witness itself."""
    inst = Instance("no rounds", 2, 2)
    assert num_rounds(2, 2) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        proof = inst.dev.prove(inst.com, inst.transcript(), inst.l, inst.n)
        pb = cv.wnla_dev_to_bytes(proof)
        assert pb.r.shape == (33, 0, B) and torch.equal(pb.l, inst.l)
        bad = pb.l.clone(); bad[0, 0, 0] ^= 1
        ok = inst.dev.verify_fast(inst.com, inst.transcript(), pb._replace(l=bad))
    assert ok.tolist() == [False, True]
