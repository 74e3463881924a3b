"""Wire bytes in: the port's `native` module against the JAX package's.

`pack_batch` turns 525-byte blobs into the verifier's tensors on a named
device, field for field equal to the JAX package's arrays; the blob
round trip through the oracle; the ctypes bindings to the C++ host engine
(built by the port into its own build directory) against the JAX
package's bindings and the oracle."""

import numpy as np
import pytest
import torch

from bppp_tpu import native as jnative
from bppp_tpu_torch import native
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N, fn_inv, fn_mul
from bppp_tpu_torch.oracle.merlin import Transcript
from bppp_tpu_torch.oracle.u64 import U64RangeProof
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.utils.rng import ReplayRng, SeededRng

LABEL = b"u64 range proof"
XS = (0, 0xFEDCBA9876543210, 2**64 - 1)


@pytest.fixture(scope="module")
def proofs():
    """Three oracle u64 proofs (the JAX package's `tests/test_native.py`
    instance), their blobs, commitments and draws."""
    rng = SeededRng("native tests")
    public = U64RangeProof(
        g=oc.GENERATOR.mul(rng.scalar()),
        g_vec=[oc.GENERATOR.mul(rng.scalar()) for _ in range(16)],
        h_vec=[oc.GENERATOR.mul(rng.scalar()) for _ in range(32)],
    )
    out = []
    for x in XS:
        s, draws = rng.scalar(), rng.scalars(52)
        proof = public.prove(x, s, Transcript(LABEL), ReplayRng(draws))
        out.append(dict(x=x, s=s, draws=draws, proof=proof, com=public.commit_value(x, s),
                        blob=native.pack_oracle_proof(proof)))
    return public, out


@pytest.fixture(scope="module")
def jnat():
    """The JAX package's bindings, loaded. Its library builds at first use
    into `native/`, where parallel test workers may race to build it while
    collecting `tests/test_native.py`; a worker whose load failed in that
    race tries once more here."""
    if not jnative.available():
        jnative._tried = False
        assert jnative.available(), "the JAX package's native engine did not build"
    return jnative


def _fields(obj, name=""):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield name, obj
        return
    for field, v in zip(obj._fields, obj):
        yield from _fields(v, f"{name}.{field}")


def test_pack_batch_equals_the_jax_pack_batch_field_by_field(proofs):
    _, ps = proofs
    blobs = [p["blob"] for p in ps] + [ps[1]["blob"]]
    got = native.pack_batch(blobs, device="cpu")
    want = jnative.pack_batch(blobs)
    pairs = list(zip(_fields(got), _fields(want)))
    assert len(pairs) == 9
    for (name, a), (name_j, b) in pairs:
        assert name == name_j
        assert a.dtype == torch.int64 and a.device.type == "cpu"
        assert tuple(a.shape) == np.asarray(b).shape, name
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)), name
    # and the oracle proofs' own conversion
    ref = cv.reciprocal_proofs_to_bytes([p["proof"] for p in ps] + [ps[1]["proof"]], device="cpu")
    for (name, a), (_, b) in zip(_fields(got), _fields(ref)):
        assert torch.equal(a, b), name


def test_pack_batch_refuses_a_short_blob_and_no_blobs(proofs):
    _, ps = proofs
    with pytest.raises(ValueError):
        native.pack_batch([ps[0]["blob"], ps[1]["blob"][:-1]], device="cpu")
    with pytest.raises(ValueError):
        native.pack_batch([], device="cpu")


def test_blob_round_trip_through_the_oracle(proofs):
    _, ps = proofs
    for p in ps:
        back = native.unpack_to_oracle(p["blob"])
        want = p["proof"]
        cp, wp = back.circuit_proof, want.circuit_proof
        assert back.r.eq(want.r)
        for name in ("c_l", "c_r", "c_o", "c_s"):
            assert getattr(cp, name).eq(getattr(wp, name)), name
        assert all(a.eq(b) for a, b in zip(cp.x + cp.r, wp.x + wp.r))
        assert (cp.l, cp.n) == (wp.l, wp.n)
        assert native.pack_oracle_proof(back) == p["blob"] == jnative.pack_oracle_proof(want)


def test_bindings_agree_with_the_jax_package_and_the_oracle(jnat):
    rng = SeededRng("native field")
    a, b = rng.scalar(), rng.scalar()
    assert native.fn_mul(a, b) == jnat.fn_mul(a, b) == fn_mul(a, b)
    assert native.fn_inv(a) == fn_inv(a)
    assert native.fp_mul(a, b) == jnat.fp_mul(a, b)
    assert native.pt_mul(oc.GENERATOR.to_bytes(), a) == oc.GENERATOR.mul(a).to_bytes()
    msg = b"x" * 200  # spans a sponge boundary
    want = Transcript(b"parity")
    want.append_message(b"m", msg)
    assert native.merlin_probe(b"parity", b"m", msg, b"c") == \
        jnat.merlin_probe(b"parity", b"m", msg, b"c") == want.challenge_bytes(b"c", 32)
    assert native.lib_path() != jnat._LIB.as_posix()


def test_u64_prove_and_verify_agree_with_the_jax_bindings(proofs, jnat):
    public, ps = proofs
    p = ps[1]
    blob, vb = native.u64_prove(public, p["x"], p["s"], LABEL, p["draws"])
    assert (blob, vb) == jnat.u64_prove(public, p["x"], p["s"], LABEL, p["draws"])
    assert blob == p["blob"] and vb == p["com"].to_bytes()
    assert native.u64_verify(public, vb, LABEL, blob)
    assert jnat.u64_verify(public, vb, LABEL, blob)
    bad = bytearray(blob)
    bad[50] ^= 2
    assert not native.u64_verify(public, vb, LABEL, bytes(bad))
    assert not native.u64_verify(public, ps[0]["com"].to_bytes(), LABEL, blob)
    with pytest.raises(ValueError):
        native.u64_prove(public, p["x"], p["s"], LABEL, p["draws"][:51])
    assert N > p["s"]
