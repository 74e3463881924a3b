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
