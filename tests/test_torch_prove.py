"""The port's provers: the pieces the circuit, reciprocal and u64 layers
add for proving (`_expand_blind`, the `u64_to_*` decompositions, the
split / interleave and point-vector helpers, the commitments) against
their JAX counterparts called op by op, and the batched u64 prover as a
whole against the host oracle under replayed blinding draws — proof BYTES
equal per lane, which is what tests/test_device_u64.py holds the JAX
prover to. Runs on the CPU with the plain versions of the kernels; every
comparison is exact (tolerance 0).

The u64 prover runs ONCE for the module (minutes of eager PyTorch), at
the fixture of tests/test_torch_u64_verify.py: seed "device u64", values
123456 and 2^64 - 1. That file feeds the very bytes compared here to the
fast and to the mirror verifier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu.protocol import circuit as jcircuit
from bppp_tpu.protocol import points as jpv
from bppp_tpu.protocol import reciprocal as jrecip
from bppp_tpu.protocol import u64 as ju64
from bppp_tpu.protocol import vectors as jsv
from bppp_tpu_torch.models import u64_fixture, u64_prove_batch
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.circuit import PartitionType
from bppp_tpu_torch.oracle.field import N
from bppp_tpu_torch.oracle.merlin import Transcript as HostTranscript
from bppp_tpu_torch.protocol import circuit as tcircuit
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol import points as pv
from bppp_tpu_torch.protocol import reciprocal as trecip
from bppp_tpu_torch.protocol import u64 as tu64
from bppp_tpu_torch.protocol import vectors as sv
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import ReplayRng, SeededRng

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

LABEL = b"u64 range proof"
XS = [123456, 2**64 - 1]
gen = np.random.default_rng(2718)


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def J(a):
    return jnp.asarray(a.numpy().astype(np.uint32))


def same(t, j):
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def rand_limbs(*shape):
    return T(gen.integers(0, 1 << 16, size=(16,) + shape))


# -- blinding draws ---------------------------------------------------------------


def test_blind_draw_counts():
    assert tcircuit.n_blind_draws(17, 16) == jcircuit.n_blind_draws(17, 16) == 51
    assert trecip.reciprocal_blind_draws(16) == jrecip.reciprocal_blind_draws(16) == 52
    assert tu64.U64_BLIND_DRAWS == ju64.U64_BLIND_DRAWS == 52
    assert (tcircuit.RO_DRAWS, tcircuit.RL_DRAWS, tcircuit.RR_DRAWS) == (7, 6, 5)


def test_expand_blind_matches_jax():
    """Draw order ro(7), rl(6), rr(5), rest; the fixed zero lanes at
    ro{4, 8}, rl{3, 7, 8}, rr{2, 6, 7, 8}."""
    blind = rand_limbs(51, 3)
    mine = tcircuit._expand_blind(blind)
    theirs = jcircuit._expand_blind(J(blind))
    assert [tuple(m.shape) for m in mine] == [(16, 9, 3)] * 3 + [(16, 33, 3)]
    assert all(same(m, t) for m, t in zip(mine, theirs))
    ro, rl, rr, rest = mine
    for vec, zeros in ((ro, {4, 8}), (rl, {3, 7, 8}), (rr, {2, 6, 7, 8})):
        dead = [j for j in range(9) if int(vec[:, j].abs().sum()) == 0]
        assert set(dead) == zeros
    assert torch.equal(ro[:, 0], blind[:, 0]) and torch.equal(rl[:, 0], blind[:, 7])
    assert torch.equal(rr[:, 0], blind[:, 13]) and torch.equal(rest, blind[:, 18:])


# -- u64 decompositions -------------------------------------------------------------

VALUES = [0, 1, 123456, 0xDEADBEEFCAFEBABE, 2**64 - 1, 0x0123456789ABCDEF, 0xFFFFFFFF, 1 << 32]
WORDS = T([[v & 0xFFFFFFFF for v in VALUES], [v >> 32 for v in VALUES]])


@pytest.mark.parametrize("name", ["u64_to_limbs", "u64_digits", "u64_to_hex", "u64_to_hex_mapped"])
def test_u64_decomposition_matches_jax(name):
    got = getattr(tu64, name)(WORDS)
    assert got.dtype == torch.int64
    assert same(got, getattr(ju64, name)(J(WORDS)))


def test_u64_decompositions_mean_what_they_say():
    assert tf.limbs_to_ints(tu64.u64_to_limbs(WORDS)) == VALUES
    digits = tu64.u64_digits(WORDS)
    hexed = tu64.u64_to_hex(WORDS)
    mapped = tu64.u64_to_hex_mapped(WORDS)
    assert hexed.shape == mapped.shape == (16, 16, len(VALUES))
    for b, v in enumerate(VALUES):
        want = [(v >> (4 * i)) & 15 for i in range(16)]
        assert digits[:, b].tolist() == want
        assert cv.scalars_lane(hexed, b) == want
        assert cv.scalars_lane(mapped, b) == [want.count(d) for d in range(16)]


def test_values_keep_a_batch_shape():
    words = WORDS.reshape(2, 2, 4)
    assert tu64.u64_to_hex_mapped(words).shape == (16, 16, 2, 4)
    assert torch.equal(tu64.u64_to_limbs(words).reshape(16, 8), tu64.u64_to_limbs(WORDS))


# -- vector and point-vector helpers ------------------------------------------------


@pytest.mark.parametrize("L", [1, 4, 5])
def test_sv_split_interleave_neg_match_jax(L):
    a = rand_limbs(L, 2)
    a = T(tf.ints_to_limbs([v % N for v in tf.limbs_to_ints(a.reshape(16, -1))])).reshape(16, L, 2)
    lo, hi = sv.sv_split(a)
    jlo, jhi = jsv.sv_split(J(a))
    assert same(lo, jlo) and same(hi, jhi)
    assert lo.shape[1] == (L + 1) // 2 and hi.shape[1] == L // 2
    assert same(sv.sv_neg(a), jsv.sv_neg(J(a)))
    if L % 2 == 0:
        assert torch.equal(sv.sv_interleave(lo, hi), a)
        assert same(sv.sv_interleave(hi, lo), jsv.sv_interleave(J(hi), J(lo)))


G = [oc.GENERATOR.mul(3 + 5 * i) for i in range(5)]


def test_pv_split_and_add_match_jax():
    p = tc.from_int_points(G, batch=(2,), device="cpu")  # (16, 5, 2)
    jp = jc.PointJ(*(J(c) for c in p))
    even, odd = pv.pv_split(p)
    jeven, jodd = jpv.pv_split(jp)
    assert pv.pv_len(even) == 3 and pv.pv_len(odd) == 2
    assert all(same(a, b) for a, b in zip(even + odd, jeven + jodd))
    got = pv.pv_add(even, odd)  # the shorter operand is identity-padded
    assert all(same(a, b) for a, b in zip(got, jpv.pv_add(jeven, jodd)))
    want = [G[0].add(G[1]), G[2].add(G[3]), G[4]]
    assert [q.to_bytes() for q in cv.point_vec_lane(got, 1)] == [q.to_bytes() for q in want]


# -- the prove batch fixture ------------------------------------------------------------


def test_prove_batch_draw_order_and_tiling():
    """Per value: s first, then the 52 blinding draws, as the reference's
    bench and tests draw them; distinct lanes tile over the batch."""
    xs = [7, 2**64 - 1, 1 << 40]
    pbt = u64_prove_batch(SeededRng("order"), xs, 7, device="cpu")
    rng = SeededRng("order")
    for ln, x in zip(pbt.lanes, xs):
        assert ln["x"] == x and ln["s"] == rng.scalar() and ln["draws"] == rng.scalars(52)
    assert pbt.x_words.shape == (2, 7) and pbt.s.shape == (16, 7) and pbt.blind.shape == (16, 52, 7)
    for b in range(7):
        ln = pbt.lanes[b % 3]
        assert int(pbt.x_words[0, b]) | (int(pbt.x_words[1, b]) << 32) == ln["x"]
        assert cv.scalar_lane(pbt.s, b) == ln["s"]
        assert cv.scalars_lane(pbt.blind, b) == ln["draws"]
    with pytest.raises(ValueError):
        u64_prove_batch(SeededRng("order"), [1 << 64], 1, device="cpu")


# -- commitments ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def instance():
    public, dev, rng = u64_fixture("device u64", 2, device="cpu", tables="never")
    return public, dev, u64_prove_batch(rng, XS, 2, device="cpu")


def test_commit_value_matches_oracle(instance):
    public, dev, pbt = instance
    got = tc.compress(dev.commit_value(pbt.x_words, pbt.s))
    for b, ln in enumerate(pbt.lanes):
        assert bytes(got[:, b].tolist()) == public.commit_value(ln["x"], ln["s"]).to_bytes()


def test_circuit_commitment_is_value_plus_poles(instance):
    """commit_poles (17 points: ladder + sum) against the oracle, and the
    identity the prover rests on: circuit.commit([x || r], s + r_blind) ==
    commit_value(x, s) + commit_poles(r, r_blind)."""
    public, dev, pbt = instance
    recip = dev._reciprocal()
    r = rand_limbs(16, 2) % (1 << 15)
    r_blind = rand_limbs(2) % (1 << 15)
    x = tu64.u64_to_limbs(pbt.x_words)
    poles = recip.commit_poles(r, r_blind)
    for b in range(2):
        rs = cv.scalars_lane(r, b)
        want = public.h_vec[0].mul(cv.scalar_lane(r_blind, b))
        for i, ri in enumerate(rs):
            want = want.add(public.h_vec[9 + i].mul(ri))
        assert cv.point_lane(poles, b).to_bytes() == want.to_bytes()
    circuit = recip.make_circuit(rand_limbs(2) % (1 << 15))
    whole = circuit.commit(torch.cat([x[:, None], r], dim=1), tf.fn_add(pbt.s, r_blind))
    parts = tc.pt_add(recip.commit_value(x, pbt.s), poles)
    assert torch.equal(tc.compress(whole), tc.compress(parts))


def test_part_vec_matches_jax(instance):
    _, dev, _ = instance
    e = rand_limbs(2) % (1 << 15)
    circuit = dev._reciprocal().make_circuit(e)
    w_o = rand_limbs(16, 2)
    jcirc = jcircuit.ArithmeticCircuitDevice.__new__(jcircuit.ArithmeticCircuitDevice)
    jcirc.partition, jcirc.batch = circuit.partition, (2,)
    for typ, size in ((PartitionType.LL, 17), (PartitionType.NO, 16), (PartitionType.LO, 17)):
        got = circuit._part_vec(w_o, typ, size)
        assert got.shape == (16, size, 2)
        assert same(got, jcirc._part_vec(J(w_o), typ, size))
    ll = circuit._part_vec(w_o, PartitionType.LL, 17)
    assert torch.equal(ll[:, :16], w_o) and int(ll[:, 16].abs().sum()) == 0


# -- the u64 prover as a whole ------------------------------------------------------------


@pytest.fixture(scope="module")
def proved(instance):
    """ONE batched prove call (B = 2) and the oracle's proofs of the same
    lanes under the same draws."""
    public, dev, pbt = instance
    proof = dev.prove(pbt.x_words, pbt.s, Transcript(LABEL, batch=(2,), device="cpu"), pbt.blind)
    oracle = [
        public.prove(ln["x"], ln["s"], HostTranscript(LABEL), ReplayRng(ln["draws"]))
        for ln in pbt.lanes
    ]
    return proof, oracle


FIELDS = ["r", "c_l", "c_r", "c_o", "c_s", "wnla_r", "wnla_x", "l", "n"]


def _field(proof, name):
    """Bytes / ints of one field of an oracle ReciprocalProof."""
    cp = proof.circuit_proof
    if name == "r":
        return proof.r.to_bytes()
    if name in ("c_l", "c_r", "c_o", "c_s"):
        return getattr(cp, name).to_bytes()
    if name in ("wnla_r", "wnla_x"):
        return [p.to_bytes() for p in getattr(cp, name[-1])]
    return list(getattr(cp, name))


@pytest.mark.parametrize("lane", [0, 1])
def test_u64_prover_bytes_equal_oracle(proved, lane):
    """Every field of the lane's proof, so the tests that share the one
    prove call stay few and next to each other."""
    proof, oracle = proved
    got = cv.reciprocal_dev_to_oracle(proof, lane)
    differing = [name for name in FIELDS if _field(got, name) != _field(oracle[lane], name)]
    assert not differing, f"lane {lane}: fields {differing} differ from the oracle's"


def test_u64_proof_goes_to_wire_form_on_its_device(proved):
    """`reciprocal_dev_to_bytes` gives exactly the tensors the oracle's
    proofs lift to — the bytes both verifiers are fed in
    tests/test_torch_u64_verify.py — in the shapes of a u64 proof: 13
    points and 3 scalars per lane."""
    proof, oracle = proved
    pb = cv.reciprocal_dev_to_bytes(proof)
    want = cv.reciprocal_proofs_to_bytes(oracle, device="cpu")
    w = pb.circuit.wnla
    assert w.r.shape == w.x.shape == (33, 4, 2) and w.l.shape == (16, 2, 2) and w.n.shape == (16, 1, 2)
    flat = lambda p: [p.r, p.circuit.c_l, p.circuit.c_r, p.circuit.c_o, p.circuit.c_s,
                      *p.circuit.wnla]
    assert all(torch.equal(a, b) for a, b in zip(flat(pb), flat(want)))


@pytest.mark.slow
def test_u64_prover_matches_the_jax_prover(instance, proved):
    """The same inputs through the JAX package's prover, whole (the program
    tests/test_device_u64.py caches): the two provers' proofs agree as
    compressed bytes and scalars. Slow: XLA compiles the whole prover for
    the CPU."""
    from bppp_tpu.oracle import curve as joc
    from bppp_tpu.protocol import convert as jcv
    from bppp_tpu.transcript.device import Transcript as JaxTranscript
    from bppp_tpu.utils import aot

    public, _, pbt = instance
    proof, _ = proved
    lift = lambda p: joc.Point(p.x, p.y, p.z)
    jdev = ju64.U64RangeProofDevice(
        g=jcv.point_batched(lift(public.g), 2),
        g_vec=jcv.points_batched([lift(p) for p in public.g_vec], 2),
        h_vec=jcv.points_batched([lift(p) for p in public.h_vec], 2),
    )
    args = dict(x=cv.to_reference(pbt.x_words), s=cv.to_reference(pbt.s),
                blind=cv.to_reference(pbt.blind))

    def fn(args):
        return jdev.prove(args["x"], args["s"], JaxTranscript(LABEL, batch=(2,)), args["blind"])

    jproof = aot.cached("test_u64_prove", fn)(args)
    as_np = lambda t: type(t)(*(as_np(v) for v in t)) if hasattr(t, "_fields") else np.asarray(t)
    theirs = cv.from_reference(as_np(jproof), device="cpu")
    assert type(theirs) is type(proof)
    mine_b, theirs_b = cv.reciprocal_dev_to_bytes(proof), cv.reciprocal_dev_to_bytes(theirs)
    assert torch.equal(mine_b.r, theirs_b.r)
    for a, b in zip(mine_b.circuit[:4] + tuple(mine_b.circuit.wnla),
                    theirs_b.circuit[:4] + tuple(theirs_b.circuit.wnla)):
        assert torch.equal(a, b)
