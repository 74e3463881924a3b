"""State carried across the two packages: `from_reference` takes the JAX
package's pytrees as numpy arrays and returns the port's containers,
`to_reference` goes back. Exact equality throughout."""

import numpy as np
import pytest
import torch

from bppp_tpu.ops import curve as jc
from bppp_tpu.oracle import curve as joc
from bppp_tpu.protocol import convert as jcv
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.ops import cuda_fixed_base as cfb
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import fixed_base as fb
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol.circuit import CircuitProofBytes
from bppp_tpu_torch.protocol.reciprocal import ReciprocalProofBytes
from bppp_tpu_torch.protocol.wnla import WNLAProofBytes

rng = np.random.default_rng(31)


def test_point_pytree_roundtrip():
    pts = [joc.GENERATOR.mul(3 + i) for i in range(4)]
    jp = jcv.points_batched(pts, 2)  # JAX PointJ, coords (16, 4, 2) uint32
    as_np = type(jp)(*(np.asarray(c) for c in jp))
    tp = cv.from_reference(as_np, device="cpu")
    assert isinstance(tp, tc.PointJ) and tp.x.dtype == torch.int64
    assert tp.x.shape == (16, 4, 2)
    mine = cv.points_batched([oc.Point(p.x, p.y, p.z) for p in pts], 2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp, mine))
    back = cv.to_reference(tp)
    assert all(b.dtype == np.uint32 and np.array_equal(a, b) for a, b in zip(as_np, back))


def test_generator_set_dict_and_masks():
    g = jcv.point_batched(joc.GENERATOR, 3)
    state = {"g": type(g)(*(np.asarray(c) for c in g)), "ok": np.array([True, False, True]),
             "none": None, "pair": (np.arange(4, dtype=np.uint32), [np.uint32(7)])}
    got = cv.from_reference(state, device="cpu")
    assert isinstance(got["g"], tc.PointJ) and got["none"] is None
    assert got["pair"][0].tolist() == [0, 1, 2, 3] and got["pair"][1][0].item() == 7
    back = cv.to_reference({"g": got["g"], "mask": torch.tensor([True, False])})
    assert back["mask"].dtype == np.bool_ and back["g"].x.dtype == np.uint32


def test_proof_bytes_roundtrip():
    from bppp_tpu.protocol.circuit import CircuitProofBytes as JC
    from bppp_tpu.protocol.reciprocal import ReciprocalProofBytes as JR
    from bppp_tpu.protocol.wnla import WNLAProofBytes as JW

    B = 2
    u32 = lambda *s: rng.integers(0, 256, size=s).astype(np.uint32)
    jproof = JR(
        circuit=JC(c_l=u32(33, B), c_r=u32(33, B), c_o=u32(33, B), c_s=u32(33, B),
                   wnla=JW(r=u32(33, 4, B), x=u32(33, 4, B), l=u32(16, 2, B), n=u32(16, 1, B))),
        r=u32(33, B),
    )
    tp = cv.from_reference(jproof, device="cpu")
    assert isinstance(tp, ReciprocalProofBytes)
    assert isinstance(tp.circuit, CircuitProofBytes) and isinstance(tp.circuit.wnla, WNLAProofBytes)
    assert tp.circuit.wnla.r.shape == (33, 4, B) and tp.circuit.wnla.l.shape == (16, 2, B)
    assert tp.r.dtype == torch.int64
    back = cv.to_reference(tp)
    assert np.array_equal(back.circuit.wnla.x, jproof.circuit.wnla.x)
    assert np.array_equal(back.circuit.c_s, jproof.circuit.c_s) and np.array_equal(back.r, jproof.r)


def test_host_bridges_match_the_jax_package():
    pts = [oc.GENERATOR.mul(11 + i) for i in range(3)]
    jpts = [joc.Point(p.x, p.y, p.z) for p in pts]
    assert np.array_equal(cv.point_bytes(pts), jcv.point_bytes(jpts).astype(np.int64))
    cols = [[5, 6, 7], [1 << 200, 0, 3]]
    assert np.array_equal(cv.scalar_cols(cols), jcv.scalar_cols(cols).astype(np.int64))
    assert np.array_equal(
        cv.compressed_cols([pts, pts[::-1]]), jcv.compressed_cols([jpts, jpts[::-1]]).astype(np.int64)
    )
    assert cv.points_batched([], 2, device="cpu").x.shape == (16, 0, 2)


def test_rejects_what_has_no_counterpart():
    with pytest.raises(TypeError):
        cv.from_reference(np.zeros(3, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError):
        cv.to_reference(torch.tensor([-1]))


def test_tables_are_rebuilt_not_carried():
    """The port builds its own window tables; their entries equal
    to_affine of the reference's points' multiples."""
    pts = [joc.GENERATOR.mul(21 + i) for i in range(2)]
    jp = jcv.points_batched(pts, 1)
    tp = cv.from_reference(type(jp)(*(np.asarray(c)[:, :, 0] for c in jp)), device="cpu")
    tab = fb.build_tables(tp, 2)
    tx, ty = cfb.table_affine(tab)  # (16, NW, F, 4)
    for w in (0, 1, 127):
        for i, p in enumerate(pts):
            mult = [p.mul(d << (2 * w)) for d in (1, 2, 3)]
            jx, jy, _ = jc.to_affine(jc.from_int_points(mult))
            assert np.array_equal(tx[:, w, i, 1:].numpy(), np.asarray(jx).astype(np.int64))
            assert np.array_equal(ty[:, w, i, 1:].numpy(), np.asarray(jy).astype(np.int64))


# -- lowering results to the host, and the prover's containers -----------------------


def test_lane_readers_match_the_jax_package():
    limbs = rng.integers(0, 1 << 16, size=(16, 3, 2))
    t = torch.from_numpy(limbs)
    for b in range(2):
        assert cv.scalars_lane(t, b) == jcv.scalars_lane(limbs.astype(np.uint32), b)
        assert cv.scalar_lane(t[:, 1], b) == jcv.scalar_lane(limbs[:, 1].astype(np.uint32), b)
    pts = [oc.GENERATOR.mul(31 + i) for i in range(3)]
    vec = cv.points_batched(pts, 2, device="cpu")  # (16, 3, 2)
    jvec = jc.PointJ(*(c.numpy().astype(np.uint32) for c in vec))
    got = cv.point_vec_lane(vec, 1)
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in pts]
    assert [(p.x, p.y, p.z) for p in got] == [(p.x, p.y, p.z) for p in jcv.point_vec_lane(jvec, 1)]
    one = tc.PointJ(*(c[:, 2] for c in vec))
    assert cv.point_lane(one, 0).to_bytes() == pts[2].to_bytes()
    jone = jcv.point_lane(jc.PointJ(*(c[:, 2] for c in jvec)), 0)
    assert (cv.point_lane(one, 0).x, cv.point_lane(one, 0).z) == (jone.x, jone.z)


def _dev_proof(B=2, K=2):
    """A ReciprocalProofDev-shaped proof of the JAX package's classes, its
    points multiples of the generator, as numpy arrays."""
    from bppp_tpu.protocol.circuit import CircuitProofDev as JC
    from bppp_tpu.protocol.reciprocal import ReciprocalProofDev as JR
    from bppp_tpu.protocol.wnla import WNLAProofDev as JW

    def pt(k, *shape):
        p = jcv.points_batched([joc.GENERATOR.mul(k + i) for i in range(shape[0])], B) \
            if shape else jcv.point_batched(joc.GENERATOR.mul(k), B)
        return type(p)(*(np.asarray(c) for c in p))

    u32 = lambda *s: rng.integers(0, 1 << 16, size=s).astype(np.uint32)
    return JR(
        circuit=JC(c_l=pt(2), c_r=pt(3), c_o=pt(4), c_s=pt(5),
                   wnla=JW(r=pt(6, K), x=pt(9, K), l=u32(16, 2, B), n=u32(16, 1, B))),
        r=pt(12),
    )


def test_device_proofs_and_witnesses_cross_and_come_back():
    from bppp_tpu.protocol.circuit import CircuitWitnessDev as JCW
    from bppp_tpu.protocol.reciprocal import ReciprocalWitnessDev as JRW
    from bppp_tpu_torch.protocol.circuit import CircuitProofDev, CircuitWitnessDev
    from bppp_tpu_torch.protocol.reciprocal import ReciprocalProofDev, ReciprocalWitnessDev
    from bppp_tpu_torch.protocol.wnla import WNLAProofDev

    jproof = _dev_proof()
    tp = cv.from_reference(jproof, device="cpu")
    assert isinstance(tp, ReciprocalProofDev) and isinstance(tp.circuit, CircuitProofDev)
    assert isinstance(tp.circuit.wnla, WNLAProofDev) and isinstance(tp.r, tc.PointJ)
    assert isinstance(tp.circuit.wnla.x, tc.PointJ) and tp.circuit.wnla.x.x.shape == (16, 2, 2)
    back = cv.to_reference(tp)
    assert np.array_equal(back.circuit.wnla.r.y, jproof.circuit.wnla.r.y)
    assert np.array_equal(back.circuit.wnla.l, jproof.circuit.wnla.l)
    u32 = lambda *s: rng.integers(0, 1 << 16, size=s).astype(np.uint32)
    cw = cv.from_reference(JCW(v=u32(16, 1, 17, 2), s_v=u32(16, 1, 2), w_l=u32(16, 16, 2),
                               w_r=u32(16, 16, 2), w_o=u32(16, 16, 2)), device="cpu")
    assert isinstance(cw, CircuitWitnessDev) and cw.v.shape == (16, 1, 17, 2)
    rw = cv.from_reference(JRW(x=u32(16, 2), s=u32(16, 2), m=u32(16, 16, 2),
                               digits=u32(16, 16, 2)), device="cpu")
    assert isinstance(rw, ReciprocalWitnessDev) and rw.digits.dtype == torch.int64


def test_device_proof_to_oracle_and_to_wire_form():
    """`*_dev_to_oracle` against the JAX package's on the same proof, and
    `reciprocal_dev_to_bytes` against compressing each point on the host."""
    jproof = _dev_proof()
    tp = cv.from_reference(jproof, device="cpu")
    for b in range(2):
        mine, theirs = cv.reciprocal_dev_to_oracle(tp, b), jcv.reciprocal_dev_to_oracle(jproof, b)
        assert mine.r.to_bytes() == theirs.r.to_bytes() == joc.GENERATOR.mul(12).to_bytes()
        m, t = mine.circuit_proof, theirs.circuit_proof
        assert [p.to_bytes() for p in (m.c_l, m.c_r, m.c_o, m.c_s, *m.r, *m.x)] == [
            p.to_bytes() for p in (t.c_l, t.c_r, t.c_o, t.c_s, *t.r, *t.x)]
        assert m.l == t.l and m.n == t.n
        w = cv.wnla_dev_to_oracle(tp.circuit.wnla, b)
        assert w.l == m.l and [p.to_bytes() for p in w.x] == [p.to_bytes() for p in m.x]
    pb = cv.reciprocal_dev_to_bytes(tp)
    assert isinstance(pb, ReciprocalProofBytes) and pb.circuit.wnla.x.shape == (33, 2, 2)
    lane0 = cv.reciprocal_dev_to_oracle(tp, 0)
    assert bytes(pb.r[:, 0].tolist()) == lane0.r.to_bytes()
    assert bytes(pb.circuit.c_o[:, 0].tolist()) == lane0.circuit_proof.c_o.to_bytes()
    assert bytes(pb.circuit.wnla.r[:, 1, 0].tolist()) == lane0.circuit_proof.r[1].to_bytes()
    assert torch.equal(pb.circuit.wnla.l, tp.circuit.wnla.l)
    both = [cv.reciprocal_dev_to_oracle(tp, b).circuit_proof for b in range(2)]
    wire = cv.wnla_proofs_to_bytes(both, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(wire, pb.circuit.wnla))
