"""The standalone arithmetic circuit of the port on its generic dense path
(no `collect_c` override) against the host oracle and the JAX package.

The ac_works instance (x + y = r, x * y = z; `models.circuit_fixture("ac",
...)`, lane 0 the JAX package's `tests/test_device_circuit.py` lane 0) at
B = 2: the prover's bytes per lane equal the oracle's under the replayed
draws, and both verifiers accept the honest lanes and reject a tampered
C_S. The reciprocal-decomposition circuit at the u64 dims, lifted by
`circuit_from_oracle`: the generic `_collect_c` equals the reciprocal
layer's closed form limb for limb. `slow`: the whole reciprocal circuit's
prove against the oracle, and ac_works against the JAX
`ArithmeticCircuitDevice` (a cold XLA compile of its prover and mirror verifier).
"""

import numpy as np
import pytest
import torch

from bppp_tpu.protocol import convert as jcv
from bppp_tpu_torch.models import CIRCUIT_LABEL, CIRCUIT_SEED, circuit_fixture
from bppp_tpu_torch.ops import curve as dc
from bppp_tpu_torch.ops import field as f
from bppp_tpu_torch.oracle.field import N
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol import vectors as sv
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import SeededRng

B = 2
DEV = "cpu"


@pytest.fixture(scope="module")
def ac():
    return circuit_fixture("ac", B, device=DEV, tables="never")


def _transcript(batch):
    return Transcript(CIRCUIT_LABEL, batch=(batch,), device=DEV)


def _same(ours, theirs):
    """A port tensor (or PointJ / proof container) equals the JAX package's
    array(s): same shape, same values."""
    if isinstance(ours, torch.Tensor):
        a = np.asarray(theirs)
        assert tuple(ours.shape) == a.shape
        assert np.array_equal(ours.numpy(), a.astype(np.int64))
        return
    assert len(ours) == len(theirs)
    for x, y in zip(ours, theirs):
        _same(x, y)


def test_convert_functions_match_the_jax_package(ac):
    rows = [[0, 1, N - 1], [5, 2**200 + 3, 0]]
    _same(cv.matrix_const(rows, 3, device=DEV), jcv.matrix_const(rows, 3))
    _same(cv.vector_const([7, N - 2], 3, device=DEV), jcv.vector_const([7, N - 2], 3))
    assert cv.matrix_const(rows, 3, device=DEV).stride()[-1] == 0  # a view over the lanes
    proofs = [ln["proof"] for ln in ac.lanes]
    _same(cv.circuit_proofs_to_bytes(proofs, device=DEV), jcv.circuit_proofs_to_bytes(proofs))
    ours, theirs = cv.circuit_from_oracle(ac.circuit, 3, device=DEV), jcv.circuit_from_oracle(ac.circuit, 3)
    for name in ("dim_nm", "dim_no", "k", "dim_nl", "dim_nv", "dim_nw", "f_l", "f_m"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ("g", "g_vec", "h_vec", "g_vec_", "h_vec_", "W_m", "W_l", "a_m", "a_l"):
        _same(getattr(ours, name), getattr(theirs, name))
    assert ours.partition is ac.circuit.partition and ours.collect_c_override is None
    assert ours.tables is None and cv.circuit_from_oracle(ac.circuit, 3, DEV, tables={}).tables == {}
    assert ac.dev.g_vec_.x.shape == (16, 0, B)  # ac_works pads no g


def test_ac_works_prove_bytes_equal_the_oracle_per_lane(ac):
    proof = ac.dev.prove(ac.v, ac.v_bytes, ac.witness, _transcript(B), ac.blind)
    assert len(ac.lanes) == B
    got = cv.circuit_dev_to_bytes(proof)
    want = cv.circuit_proofs_to_bytes([ln["proof"] for ln in ac.lanes], device=DEV)
    for name, a, b in (("c_l", got.c_l, want.c_l), ("c_r", got.c_r, want.c_r),
                       ("c_o", got.c_o, want.c_o), ("c_s", got.c_s, want.c_s)):
        assert torch.equal(a, b), name
    for name, a, b in zip(got.wnla._fields, got.wnla, want.wnla):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "mirror"])
def test_ac_works_verifiers_accept_both_lanes_and_reject_a_tampered_c_s(ac, fast):
    """Three lanes: the two honest proofs, then lane 0's with one bit of
    C_S's x flipped (another point, so the transcript diverges)."""
    lanes = [0, 1, 0]
    pick = lambda a: a[..., lanes].contiguous()
    pb = cv.circuit_proofs_to_bytes([ac.lanes[i]["proof"] for i in lanes], device=DEV)
    bad = pb.c_s.clone()
    bad[1, 2] ^= 1
    dev3 = cv.circuit_from_oracle(ac.circuit, len(lanes), device=DEV)
    v3 = dc.PointJ(*(pick(a) for a in ac.v))
    ok = dev3.verify(v3, pick(ac.v_bytes), _transcript(len(lanes)), pb._replace(c_s=bad), fast=fast)
    assert ok.tolist() == [True, True, False]


def test_generic_collect_c_equals_the_reciprocal_closed_form():
    """The generic `_collect_c` over the dense W of the lifted reciprocal
    circuit (`make_circuit(e)` of the oracle at the u64 dims) against the
    closed form that `ReciprocalRangeProofDevice.make_circuit(e)` passes,
    on the same (lambda_vec, mu_vec, mu^-1) of two lanes."""
    from bppp_tpu_torch.models import _reciprocal_circuit
    from bppp_tpu_torch.protocol.reciprocal import ReciprocalRangeProofDevice

    rng = SeededRng("collect_c")
    circ, _ = _reciprocal_circuit(rng)
    e = circ.W_m[0][circ.dim_nm]  # W_m[i][nm + i] = -e
    e = (N - e) % N
    generic = cv.circuit_from_oracle(circ, B, device=DEV)
    empty = dc.identity((0, B), device=DEV)
    closed = ReciprocalRangeProofDevice(
        dim_nd=circ.dim_nm, dim_np=circ.dim_no, g=generic.g, g_vec=generic.g_vec,
        h_vec=generic.h_vec, g_vec_=empty, h_vec_=generic.h_vec_,
    ).make_circuit(torch.from_numpy(f.ints_to_limbs([e] * B)))
    assert (generic.dim_nm, generic.dim_no, generic.dim_nv, generic.dim_nl, generic.dim_nw) == \
        (16, 16, 17, 17, 48)
    lam = torch.from_numpy(f.ints_to_limbs(rng.scalars(B)))
    mu = torch.from_numpy(f.ints_to_limbs(rng.scalars(B)))
    lambda_vec = generic._collect_lambda(lam, mu)
    mu_vec = sv.sv_powers(mu, generic.dim_nm, start_at_one=False)
    mu_inv = f.fn_inv(mu)
    got = generic._collect_c(lambda_vec, mu_vec, mu_inv)
    want = closed.collect_c_override(lambda_vec, mu_vec, mu_inv)
    for name, a, b in zip(("c_nL", "c_nR", "c_nO", "c_lL", "c_lR", "c_lO"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    # the W the generic path multiplies are the closed form's own W
    assert torch.equal(generic.W_m.expand(closed.W_m.shape), closed.W_m)
    assert torch.equal(generic.W_l.expand(closed.W_l.shape), closed.W_l)


@pytest.mark.slow
def test_reciprocal_circuit_prove_matches_the_oracle():
    """The reciprocal-decomposition circuit proved on the generic path at
    B = 2 (two values, their own blinding): bytes equal the oracle's."""
    fx = circuit_fixture("reciprocal", B, device=DEV, tables="never")
    proof = fx.dev.prove(fx.v, fx.v_bytes, fx.witness, _transcript(B), fx.blind)
    got = cv.circuit_dev_to_bytes(proof)
    want = cv.circuit_proofs_to_bytes([ln["proof"] for ln in fx.lanes], device=DEV)
    for name, a, b in zip(got._fields, got, want):
        if name != "wnla":
            assert torch.equal(a, b), name
    for name, a, b in zip(got.wnla._fields, got.wnla, want.wnla):
        assert torch.equal(a, b), name


@pytest.mark.slow
def test_ac_works_matches_the_jax_circuit(ac):
    """The JAX package's ArithmeticCircuitDevice on the same instance and
    inputs: the same proof bytes, and the same masks from the mirror
    verifier on the honest proofs and with lane 0's C_S tampered. The JAX
    programs are the two `tests/test_device_circuit.py` runs (through its
    `aot` cache, under the same names: same instance, inputs of the same
    shapes); slow: XLA compiles each whole program for the CPU, about half
    an hour each when cold. (The port's fast verifier is held to the same
    masks by `test_ac_works_verifiers_accept_both_lanes_and_reject_a_tampered_c_s`.)"""
    from bppp_tpu.protocol import circuit as jc
    from bppp_tpu.protocol import wnla as jw
    from bppp_tpu.transcript.device import Transcript as JaxTranscript
    from bppp_tpu.utils import aot
    from test_oracle_protocols import make_ac_fixture

    jcirc, _, _ = make_ac_fixture(CIRCUIT_SEED)  # the same generators, the JAX oracle's partition
    jdev = jcv.circuit_from_oracle(jcirc, B)
    ref = cv.to_reference
    args = dict(
        v=type(jdev.g)(*(ref(a) for a in ac.v)),
        v_bytes=ref(ac.v_bytes),
        blind=ref(ac.blind),
        wit=jc.CircuitWitnessDev(*(ref(a) for a in ac.witness)),
    )

    def prove(args):
        t = JaxTranscript(CIRCUIT_LABEL, batch=(B,))
        return jdev.prove(args["v"], args["v_bytes"], args["wit"], t, args["blind"])

    jproof = aot.cached("test_ac_prove", prove)(args)
    proof = ac.dev.prove(ac.v, ac.v_bytes, ac.witness, _transcript(B), ac.blind)
    for b in range(B):
        ours, theirs = cv.circuit_dev_to_oracle(proof, b), jcv.circuit_dev_to_oracle(jproof, b)
        for name in ("c_l", "c_r", "c_o", "c_s"):
            assert getattr(ours, name).to_bytes() == getattr(theirs, name).to_bytes(), name
        assert [p.to_bytes() for p in ours.x] == [p.to_bytes() for p in theirs.x]
        assert [p.to_bytes() for p in ours.r] == [p.to_bytes() for p in theirs.r]
        assert ours.l == theirs.l and ours.n == theirs.n

    pb = cv.circuit_dev_to_bytes(proof)
    bad = pb.c_s.clone()
    bad[1, 0] ^= 1

    def verify(args, pb):
        t = JaxTranscript(CIRCUIT_LABEL, batch=(B,))
        return jdev.verify(args["v"], args["v_bytes"], t, pb)

    prog = aot.cached("test_ac_verify", verify)
    for proof_bytes, want in ((pb, [True, True]), (pb._replace(c_s=bad), [False, True])):
        r = ref(proof_bytes)
        jpb = jc.CircuitProofBytes(r.c_l, r.c_r, r.c_o, r.c_s, jw.WNLAProofBytes(*r.wnla))
        ours = ac.dev.verify(ac.v, ac.v_bytes, _transcript(B), proof_bytes, fast=False)
        assert ours.tolist() == np.asarray(prog(args, jpb)).tolist() == want
