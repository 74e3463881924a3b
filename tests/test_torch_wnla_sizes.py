"""The standalone weight-norm linear argument of the port at the sizes of
the JAX package's `tests/test_device_wnla_sizes.py`, built by
`models.wnla_fixture`: |l| = |n| = 16 (three folding rounds) round-trips
against the port's oracle and the JAX package's oracle lanes, and the
odd-size contract (|l| = 6, |n| = 3) holds. Sizes 32 and 64 run on the
card (`chip_smoke.py`, phase `wnla`). Every comparison is exact: bytes
for points, integers for scalars, masks lane for lane."""

import warnings

import numpy as np
import pytest
import torch

from bppp_tpu.oracle.curve import GENERATOR as JAX_GENERATOR
from bppp_tpu.oracle.field import fn_mul as j_fn_mul
from bppp_tpu.oracle.merlin import Transcript as JaxHostTranscript
from bppp_tpu.oracle.wnla import WNLA as JaxWNLA
from bppp_tpu.protocol import convert as jcv
from bppp_tpu.utils.rng import SeededRng as JaxSeededRng
from bppp_tpu_torch.models import WNLA_DISTINCT, WNLA_LABEL, wnla_fixture
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol.wnla import num_rounds
from bppp_tpu_torch.transcript.device import Transcript

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

SZ = 16
DISTINCT = WNLA_DISTINCT
B = 4  # lanes 2 and 3 repeat lanes 0 and 1; the verifiers see lane 3 tampered
SEED = f"device wnla sz{SZ}"  # the JAX package's seed for this size


def transcript(fx, batch):
    return Transcript(fx.label, batch=(batch,), device="cpu")


def proof_bytes(proof):
    return dict(
        r=[p.to_bytes() for p in proof.r], x=[p.to_bytes() for p in proof.x],
        l=list(proof.l), n=list(proof.n),
    )


@pytest.fixture(scope="module")
def fx16():
    """The fixture at |l| = |n| = 16 without tables: two distinct lanes and
    their oracle proofs, tiled over four lanes. Each test below runs one
    eager call on it, so the tests can run side by side."""
    fx = wnla_fixture(SEED, SZ, SZ, B, device="cpu")
    assert num_rounds(SZ, SZ) == 3 and fx.dev.tables is None and len(fx.lanes) == DISTINCT
    return fx


@pytest.fixture(scope="module")
def jax_lanes():
    """The JAX package's `_build` for this size, from its own oracle and rng:
    per lane the WNLA instance, witness, commitment and proof."""
    rng = JaxSeededRng(SEED)
    g = JAX_GENERATOR.mul(rng.scalar())
    g_vec = [JAX_GENERATOR.mul(rng.scalar()) for _ in range(SZ)]
    h_vec = [JAX_GENERATOR.mul(rng.scalar()) for _ in range(SZ)]
    lanes = []
    for _ in range(DISTINCT):
        c = rng.scalars(SZ)
        rho = rng.scalar()
        l, n = rng.scalars(SZ), rng.scalars(SZ)
        w = JaxWNLA(g=g, g_vec=g_vec, h_vec=h_vec, c=c, rho=rho, mu=j_fn_mul(rho, rho))
        com = w.commit(l, n)
        lanes.append(dict(wnla=w, l=l, n=n, com=com,
                          proof=w.prove(com, JaxHostTranscript(WNLA_LABEL), l, n)))
    return lanes


def test_wnla_fixture_is_the_jax_build(fx16, jax_lanes):
    """Same seed, same draws: the fixture's generators, public scalars,
    witnesses and commitments are the JAX package's, and its device
    tensors are laid out as the JAX package's `convert` lays them out
    (lane b holding distinct lane b % DISTINCT)."""
    assert fx16.label == WNLA_LABEL
    for mine, theirs in zip(fx16.lanes, jax_lanes, strict=True):
        a, b = mine["wnla"], theirs["wnla"]
        assert [p.to_bytes() for p in [a.g] + a.g_vec + a.h_vec] == \
            [p.to_bytes() for p in [b.g] + b.g_vec + b.h_vec]
        assert (a.c, a.rho, a.mu) == (b.c, b.rho, b.mu)
        assert (mine["l"], mine["n"]) == (theirs["l"], theirs["n"])
        assert mine["com"].to_bytes() == theirs["com"].to_bytes()
    w0 = jax_lanes[0]["wnla"]
    want = dict(
        g=jcv.point_batched(w0.g, B), g_vec=jcv.points_batched(w0.g_vec, B),
        h_vec=jcv.points_batched(w0.h_vec, B),
    )
    for name, theirs in want.items():
        for a, b in zip(getattr(fx16.dev, name), theirs):
            assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)), name
    tiled = [jax_lanes[b % DISTINCT] for b in range(B)]
    assert np.array_equal(fx16.dev.c.numpy(), jcv.scalar_cols([ln["wnla"].c for ln in tiled]))
    assert np.array_equal(fx16.l.numpy(), jcv.scalar_cols([ln["l"] for ln in tiled]))
    assert np.array_equal(fx16.n.numpy(), jcv.scalar_cols([ln["n"] for ln in tiled]))


def test_wnla16_commit_matches_the_oracle(fx16):
    """`commit` over the 33 generators [g | h_vec | g_vec]: a ladder over
    33 points per lane and the sum over them."""
    got = tc.compress(fx16.dev.commit(fx16.l, fx16.n))
    assert [bytes(got[:, b].tolist()) for b in range(B)] == [
        fx16.lanes[b % DISTINCT]["com"].to_bytes() for b in range(B)]


def test_wnla16_prove_matches_both_oracles(fx16, jax_lanes):
    """`prove` takes the fast prover (16 is divisible by 2^3): every lane's
    R, X, l and n equal the port's oracle's and the JAX package's oracle's."""
    proof = fx16.dev.prove(fx16.com, transcript(fx16, B), fx16.l, fx16.n)
    assert proof.x.x.shape == (16, 3, B) and proof.l.shape == (16, 2, B)
    for b in range(B):
        got = proof_bytes(cv.wnla_dev_to_oracle(proof, b))
        assert got == proof_bytes(fx16.lanes[b % DISTINCT]["proof"])
        assert got == proof_bytes(jax_lanes[b % DISTINCT]["proof"])


@pytest.mark.parametrize("which", ["verify", "verify_fast"])
def test_wnla16_verifiers_accept_and_reject(fx16, which):
    """The oracle's proofs (which the port's prover reproduces byte for
    byte, above): lanes 0 and 1 as they are, [True, True]; lanes 2 and 3
    the same proofs with lane 3's first final scalar tampered,
    [True, False]."""
    pb = cv.wnla_proofs_to_bytes([fx16.lanes[b % DISTINCT]["proof"] for b in range(B)],
                                 device="cpu")
    bad = pb.l.clone()
    bad[0, 0, 3] = (bad[0, 0, 3] + 1) % (1 << 16)
    ok = getattr(fx16.dev, which)(fx16.com, transcript(fx16, B), pb._replace(l=bad))
    assert ok.dtype == torch.bool and ok.tolist() == [True, True, True, False]


def test_wnla_odd_size_contract():
    """|l| = 6, |n| = 3 is not divisible by 2^K (K = 1, |n| odd): `prove`
    and `verify_fast` warn and give way to the mirror versions; the proof
    still equals the oracle's bit for bit and verifies, and a tampered
    scalar is rejected."""
    fx = wnla_fixture("device wnla odd", 6, 3, 4, device="cpu")
    assert num_rounds(6, 3) == 1
    with pytest.warns(UserWarning, match="mirror prover"):
        proof = fx.dev.prove(fx.com, transcript(fx, 4), fx.l, fx.n)
    for b in range(4):
        assert proof_bytes(cv.wnla_dev_to_oracle(proof, b)) == proof_bytes(fx.lanes[b % DISTINCT]["proof"])
    pb = cv.wnla_dev_to_bytes(proof)
    bad = pb.l.clone()
    bad[0, 0, 3] = (bad[0, 0, 3] + 1) % (1 << 16)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ok = fx.dev.verify_fast(fx.com, transcript(fx, 4), pb._replace(l=bad))
    assert any("mirror verifier" in str(w.message) for w in rec)
    assert ok.tolist() == [True, True, True, False]
