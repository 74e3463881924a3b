"""Batched u64 range-proof verification as a whole, through the port's
collapsed verifier and through its mirror verifier, on the CPU (plain
versions of the kernels), at the fixture of tests/test_device_u64.py.
Accept masks are compared exactly with the expected ones, with each other,
with the port's copy of the host oracle, and — marked slow — with the JAX
package's verifier; the challenges the two packages' transcripts derive
from the same bytes are compared limb for limb.

All tampered and malformed cases ride as lanes of ONE batch (each case is
a pair of lanes: the fixture's two proofs with the case's tamper applied
to one of them), because a verify call on the CPU costs tens of seconds
whatever its batch."""

import json
import os

import numpy as np
import pytest
import torch

from bppp_tpu_torch.models import u64_fixture
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import serde
from bppp_tpu_torch.oracle.field import N, P
from bppp_tpu_torch.oracle.merlin import Transcript as HostTranscript
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import ReplayRng

LABEL = b"u64 range proof"
XS = [123456, 2**64 - 1]
U64_BLIND_DRAWS = 52
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _set(proof, **kw):
    """Replace fields of a ReciprocalProofBytes by name: r, c_s, c_l, ...
    on the circuit, l / n / x / wr (the WNLA r) on the WNLA proof."""
    circuit, wnla = proof.circuit, proof.circuit.wnla
    top = {k: kw.pop(k) for k in ("r",) if k in kw}
    w = {("r" if k == "wr" else k): kw.pop(k) for k in ("l", "n", "x", "wr") if k in kw}
    return proof._replace(circuit=circuit._replace(wnla=wnla._replace(**w), **kw), **top)


def _cases(pb):
    """name -> (tampered proof, expected mask of the lane pair); the first
    four are the cases of tests/test_device_u64.py:119-146, the rest those
    of its malformed-bytes test."""
    out = {"valid": (pb, [True, True])}
    bad = pb.r.clone(); bad[5, 0] ^= 0x40
    out["tampered_r"] = (_set(pb, r=bad), [False, True])
    bad = pb.circuit.wnla.l.clone(); bad[0, 0, 1] = (bad[0, 0, 1] + 1) % (1 << 16)
    out["tampered_l"] = (_set(pb, l=bad), [True, False])
    bad = pb.circuit.wnla.x.clone(); bad[3, 2, 0] ^= 0x11
    out["tampered_middle_x"] = (_set(pb, x=bad), [False, True])

    x_nr = next(x for x in range(2, 100) if pow(x**3 + 7, (P - 1) // 2, P) != 1)
    bad = pb.r.clone(); bad[0, 0] = 2; bad[1:, 0] = torch.tensor(list(x_nr.to_bytes(32, "big")))
    out["off_curve_x"] = (_set(pb, r=bad), [False, True])
    bad = pb.circuit.c_s.clone(); bad[0, 0] = 7
    out["bad_sec1_tag"] = (_set(pb, c_s=bad), [False, True])
    bad = pb.r.clone(); bad[0, 1] = 2; bad[1:, 1] = 0xFF
    out["x_not_below_p"] = (_set(pb, r=bad), [True, False])
    bad = pb.circuit.wnla.l.clone()
    for i in range(16):
        bad[i, 0, 0] = ((N + 5) >> (16 * i)) & 0xFFFF
    out["scalar_not_below_n"] = (_set(pb, l=bad), [False, True])
    g = np.random.default_rng(3)
    garb = {}
    for name in ("c_l", "c_r", "c_o", "c_s"):
        b = getattr(pb.circuit, name).clone()
        b[:, 1] = torch.from_numpy(g.integers(0, 256, size=33))
        garb[name] = b
    out["garbage_points"] = (_set(pb, **garb), [True, False])
    bad = pb.circuit.wnla.l.clone()
    i = next(j for j in range(1, 16) if bad[j, 0, 0] >= 1)
    bad[i, 0, 0] -= 1; bad[i - 1, 0, 0] += 1 << 16
    out["non_normalized_limbs"] = (_set(pb, l=bad), [False, True])
    bad = pb.r.clone()
    k = next(j for j in range(1, 32, 2) if bad[j, 0] >= 1)
    bad[k, 0] -= 1; bad[k + 1, 0] += 256
    out["non_normalized_byte"] = (_set(pb, r=bad), [False, True])
    return out


CASE_NAMES = [
    "valid", "tampered_r", "tampered_l", "tampered_middle_x", "off_curve_x", "bad_sec1_tag",
    "x_not_below_p", "scalar_not_below_n", "garbage_points", "non_normalized_limbs",
    "non_normalized_byte",
]


def _cat(proofs):
    first = proofs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(proofs, dim=-1)
    return type(first)(*(_cat([p[i] for p in proofs]) for i in range(len(first))))


@pytest.fixture(scope="module")
def fixture():
    """The fixture of tests/test_device_u64.py:21-58 (seed "device u64",
    B = 2, x in {123456, 2^64 - 1}), made by the port's oracle copy."""
    public, _, rng = u64_fixture("device u64", 2, device="cpu", tables="never")
    lanes = []
    for x in XS:
        s = rng.scalar()
        draws = rng.scalars(U64_BLIND_DRAWS)
        com = public.commit_value(x, s)
        proof = public.prove(x, s, HostTranscript(LABEL), ReplayRng(draws))
        assert public.verify(com, proof, HostTranscript(LABEL))
        lanes.append(dict(x=x, s=s, draws=draws, com=com, proof=proof))
    pb = cv.reciprocal_proofs_to_bytes([ln["proof"] for ln in lanes], device="cpu")
    cb = torch.from_numpy(cv.point_bytes([ln["com"] for ln in lanes]))
    return public, lanes, pb, cb


def _case_masks(fixture, fast: bool, names=CASE_NAMES):
    """ONE verify call over the named cases -> {name: accept mask of its pair}."""
    _, _, pb, cb = fixture
    cases = _cases(pb)
    assert list(cases) == CASE_NAMES
    B = 2 * len(names)
    _, dev, _ = u64_fixture("device u64", B, device="cpu", tables="never")
    big = _cat([cases[n][0] for n in names])
    ok = dev.verify(
        cb.repeat(1, len(names)), Transcript(LABEL, batch=(B,), device="cpu"), big, fast=fast
    )
    assert ok.dtype == torch.bool and ok.shape == (B,)
    return {n: ok[2 * i : 2 * i + 2].tolist() for i, n in enumerate(names)}, cases


@pytest.fixture(scope="module")
def masks(fixture):
    return _case_masks(fixture, fast=True)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_verify_fast_case(masks, name):
    """valid accepts; each tampered or malformed input rejects exactly its
    lane, and nothing raises."""
    got, cases = masks
    assert got[name] == cases[name][1]


def test_oracle_copy_agrees(fixture):
    import copy

    public, lanes, _, _ = fixture
    for ln in lanes:
        assert public.verify(ln["com"], ln["proof"], HostTranscript(LABEL))
    bad = copy.deepcopy(lanes[1]["proof"])
    bad.circuit_proof.l[0] = (bad.circuit_proof.l[0] + 1) % N
    assert not public.verify(lanes[1]["com"], bad, HostTranscript(LABEL))
    assert not public.verify(lanes[0]["com"], lanes[1]["proof"], HostTranscript(LABEL))


def test_frozen_fixture_accepts_with_tables():
    """tests/fixtures/u64_proof.json through the flagship configuration:
    fixed-base tables present (narrow windows, so the eager build stays
    short), i.e. the plain versions of the fixed-base and small-MSM
    kernels and the complete add joining them. A wrong commitment and a
    flipped proof byte reject."""
    with open(os.path.join(FIX, "u64_proof.json")) as fh:
        fx = json.load(fh)
    public, dev, rng = u64_fixture(fx["seed"], 3, device="cpu", tables=2)
    assert dev.tables["full"].n_points == 49 and dev.tables["gv"].n_points == 17
    s = rng.scalar()
    com = public.commit_value(fx["x"], s)
    assert serde.point_to_hex(com) == fx["commitment"]
    proof = serde.reciprocal_proof_from_dict(fx["proof"])
    assert public.verify(com, proof, HostTranscript(LABEL))
    pb = cv.reciprocal_proofs_to_bytes([proof] * 3, device="cpu")
    cb = torch.from_numpy(cv.point_bytes([com, com, public.commit_value(fx["x"] + 1, s)]))
    bad = pb.circuit.c_o.clone(); bad[9, 1] ^= 1
    ok = dev.verify(cb, Transcript(LABEL, batch=(3,), device="cpu"), _set(pb, c_o=bad), fast=True)
    assert ok.tolist() == [True, False, False]


def test_mirror_verifier_is_a_later_slice(fixture, masks):
    """The mirror verifier (`fast=False`; the name of this test dates from
    when the port had only the collapsed verifier) folds the generators
    round by round with the ladder and accepts exactly what
    the collapsed verifier accepts: on the valid pair, on each tampered
    proof and on a lane of garbage points (which the ladder must carry
    without raising) the two masks are equal, and equal to the expected
    one. The other malformed cases are decided by the wire checks, which
    run before the two verifiers part ways. One call, ten lanes: the plain
    ladder's cost on the CPU grows with the lanes."""
    names = ["valid", "tampered_r", "tampered_l", "tampered_middle_x", "garbage_points"]
    mirror, cases = _case_masks(fixture, fast=False, names=names)
    fast, _ = masks
    for name in names:
        assert mirror[name] == cases[name][1], name
        assert mirror[name] == fast[name], name


def test_fixture_rejects_bad_tables_argument():
    with pytest.raises(ValueError):
        u64_fixture("x", 1, device="cpu", tables="always")


def test_challenges_match_the_jax_transcript(fixture):
    """After the same absorbs, the port's and the JAX package's transcript
    give the same e, rho, lambda, beta, delta, tau and first
    wnla_challenge (op level: no protocol program is traced)."""
    import jax.numpy as jnp

    from bppp_tpu.transcript.device import Transcript as JaxTranscript

    _, _, pb, cb = fixture
    cp = pb.circuit

    def walk(t, conv):
        out = []
        t.append_message(b"reciprocal_commitment", conv(cb))
        out.append(t.challenge_scalar(b"reciprocal_challenge"))
        t.append_message(b"commitment_cl", conv(cp.c_l))
        t.append_message(b"commitment_cr", conv(cp.c_r))
        t.append_message(b"commitment_co", conv(cp.c_o))
        t.append_message(b"commitment_v", conv(cb))
        for label in (b"circuit_rho", b"circuit_lambda", b"circuit_beta", b"circuit_delta"):
            out.append(t.challenge_scalar(label))
        t.append_message(b"commitment_cs", conv(cp.c_s))
        out.append(t.challenge_scalar(b"circuit_tau"))
        t.append_message(b"wnla_com", conv(cb))
        t.append_message(b"wnla_x", conv(cp.wnla.x[:, 3]))
        t.append_message(b"wnla_r", conv(cp.wnla.r[:, 3]))
        t.append_u64(b"l.sz", 32)
        t.append_u64(b"n.sz", 16)
        out.append(t.challenge_scalar(b"wnla_challenge"))
        return out

    mine = walk(Transcript(LABEL, batch=(2,), device="cpu"), lambda a: a)
    theirs = walk(
        JaxTranscript(LABEL, batch=(2,)), lambda a: jnp.asarray(a.numpy().astype(np.uint32))
    )
    assert len(mine) == len(theirs) == 7
    for a, b in zip(mine, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        assert all(v < N for v in tf.limbs_to_ints(a))


@pytest.mark.slow
def test_accept_masks_match_the_jax_verifier(fixture, masks):
    """The same inputs through the JAX package's verifier (its mirror
    verifier, by the program tests/test_device_u64.py caches; the mirror
    and the fast verifier accept the same set, which the reference's own
    test asserts). Slow: XLA compiles the whole exported program for the
    CPU, about a quarter of an hour, even when the export is cached."""
    from bppp_tpu.oracle import curve as joc
    from bppp_tpu.protocol import convert as jcv
    from bppp_tpu.protocol.u64 import U64RangeProofDevice as JaxDevice
    from bppp_tpu.transcript.device import Transcript as JaxTranscript
    from bppp_tpu.utils import aot

    public, lanes, pb, cb = fixture
    got, cases = masks
    lift = lambda p: joc.Point(p.x, p.y, p.z)
    jdev = JaxDevice(
        g=jcv.point_batched(lift(public.g), 2),
        g_vec=jcv.points_batched([lift(p) for p in public.g_vec], 2),
        h_vec=jcv.points_batched([lift(p) for p in public.h_vec], 2),
    )
    x_words = np.zeros((2, 2), dtype=np.uint32)
    for b, ln in enumerate(lanes):
        x_words[0, b] = ln["x"] & 0xFFFFFFFF
        x_words[1, b] = ln["x"] >> 32
    args = dict(
        x=x_words,
        s=np.concatenate([jcv.f.int_to_limbs(ln["s"]) for ln in lanes], axis=1),
        blind=jcv.scalar_cols([ln["draws"] for ln in lanes]),
        com_bytes=cv.to_reference(cb),
    )

    def fn(args, jpb):
        return jdev.verify(args["com_bytes"], JaxTranscript(LABEL, batch=(2,)), jpb)

    prog = aot.cached("test_u64_verify", fn)
    from bppp_tpu.protocol.circuit import CircuitProofBytes as JC
    from bppp_tpu.protocol.reciprocal import ReciprocalProofBytes as JR
    from bppp_tpu.protocol.wnla import WNLAProofBytes as JW

    def to_jax(p):
        q = cv.to_reference(p)
        return JR(circuit=JC(*q.circuit[:4], wnla=JW(*q.circuit.wnla)), r=q.r)

    for name in ("valid", "tampered_r", "tampered_l", "tampered_middle_x"):
        want = np.asarray(prog(args, to_jax(cases[name][0]))).tolist()
        assert got[name] == want, name
