"""The port's Keccak and Merlin/STROBE transcript against the JAX package
and the host oracle, byte for byte (tolerance 0), and the constants
written into the CUDA sources against the Python ones."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.transcript import keccak as jk
from bppp_tpu.transcript.device import Transcript as JaxTranscript
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle import keccak as ok
from bppp_tpu_torch.oracle.field import N, P
from bppp_tpu_torch.oracle.merlin import Transcript as HostTranscript
from bppp_tpu_torch.oracle.merlin import get_challenge
from bppp_tpu_torch.transcript import keccak as tk
from bppp_tpu_torch.transcript.device import Transcript

rng = np.random.default_rng(99)
CSRC = os.path.join(os.path.dirname(__file__), "..", "bppp_tpu_torch", "csrc")


def cols(bs_list):
    """list of equal-length byte strings -> (n, B) int64 array."""
    return np.stack(
        [np.frombuffer(b, dtype=np.uint8).astype(np.int64) for b in bs_list], axis=1
    )


def test_f1600_bytes_matches_oracle_and_jax():
    states = [rng.bytes(200) for _ in range(3)] + [bytes(200)]
    arr = cols(states)
    out = tk.f1600_bytes(torch.from_numpy(arr))
    assert out.shape == (200, 4) and out.dtype == torch.int64
    for j, s in enumerate(states):
        assert bytes(out[:, j].tolist()) == ok.f1600_bytes(s)
    want = np.asarray(jk.f1600_bytes(jnp.asarray(arr.astype(np.uint32))))
    assert np.array_equal(out.numpy(), want.astype(np.int64))


def test_f1600_trailing_batch_shape():
    arr = rng.integers(0, 256, size=(200, 2, 3))
    out = tk.f1600_bytes(torch.from_numpy(arr))
    flat = tk.f1600_bytes(torch.from_numpy(arr.reshape(200, 6)))
    assert torch.equal(out.reshape(200, 6), flat)


def test_pack_unpack_roundtrip():
    arr = torch.from_numpy(rng.integers(0, 256, size=(200, 3)))
    lo, hi = tk.pack_bytes(arr)
    jlo, jhi = jk.pack_bytes(jnp.asarray(arr.numpy().astype(np.uint32)))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    assert torch.equal(tk.unpack_bytes(lo, hi), arr)


def _schedule(t, point_bytes, blob):
    t.append_message(b"reciprocal_commitment", point_bytes)
    e1 = t.challenge_bytes(b"reciprocal_challenge", 32)
    t.append_message(b"big", blob)  # 200 bytes: crosses the STROBE rate
    t.append_u64(b"l.sz", 32)
    t.append_u64(b"n.sz", 16)
    e2 = t.challenge_bytes(b"wnla_challenge", 32)
    return e1, e2


def test_transcript_schedule_matches_oracle_and_jax():
    B = 3
    pts = [oc.GENERATOR.mul(int.from_bytes(rng.bytes(32), "big") % N) for _ in range(B)]
    blobs = [rng.bytes(200) for _ in range(B)]
    pd, bd = cols([p.to_bytes() for p in pts]), cols(blobs)
    t = Transcript(b"u64 range proof", batch=(B,), device="cpu")
    e1, e2 = _schedule(t, torch.from_numpy(pd), torch.from_numpy(bd))
    for j in range(B):
        h1, h2 = _schedule(HostTranscript(b"u64 range proof"), pts[j].to_bytes(), blobs[j])
        assert bytes(e1[:, j].tolist()) == h1
        assert bytes(e2[:, j].tolist()) == h2
    jt = JaxTranscript(b"u64 range proof", batch=(B,))
    j1, j2 = _schedule(
        jt, jnp.asarray(pd.astype(np.uint32)), jnp.asarray(bd.astype(np.uint32))
    )
    assert np.array_equal(e1.numpy(), np.asarray(j1).astype(np.int64))
    assert np.array_equal(e2.numpy(), np.asarray(j2).astype(np.int64))
    assert (t.pos, t.pos_begin, t.cur_flags) == (jt.pos, jt.pos_begin, jt.cur_flags)
    assert np.array_equal(t.state.numpy(), np.asarray(jt.state).astype(np.int64))


@pytest.mark.parametrize("n", [1, 165, 166, 167, 400])
def test_rate_crossing_messages(n):
    """Messages that end just before, at and after the STROBE rate (166),
    and a static message absorbed the same way."""
    msg = rng.bytes(n)
    t = Transcript(b"rate", batch=(2,), device="cpu")
    t.append_message(b"m", torch.from_numpy(cols([msg, msg])))
    t.append_message(b"static", msg)
    got = t.challenge_bytes(b"c", 200)
    h = HostTranscript(b"rate")
    h.append_message(b"m", msg)
    h.append_message(b"static", msg)
    want = h.challenge_bytes(b"c", 200)
    assert bytes(got[:, 0].tolist()) == want and bytes(got[:, 1].tolist()) == want


def test_challenge_scalar():
    B = 2
    pts = [oc.GENERATOR.mul(7 + j) for j in range(B)]
    pd = cols([p.to_bytes() for p in pts])
    t = Transcript(b"wnla test", batch=(B,), device="cpu")
    t.append_message(b"wnla_com", torch.from_numpy(pd))
    got = t.challenge_scalar(b"wnla_challenge")
    for j in range(B):
        ht = HostTranscript(b"wnla test")
        ht.append_message(b"wnla_com", pts[j].to_bytes())
        assert tf.limbs_to_ints(got)[j] == get_challenge(b"wnla_challenge", ht)
    jt = JaxTranscript(b"wnla test", batch=(B,))
    jt.append_message(b"wnla_com", jnp.asarray(pd.astype(np.uint32)))
    want = np.asarray(jt.challenge_scalar(b"wnla_challenge"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# -- constants written into the CUDA sources ---------------------------------


def _c_arrays(filename):
    """{name: [ints]} for every `NAME[k] = { ... }` initializer of a source."""
    with open(os.path.join(CSRC, filename)) as fh:
        text = fh.read()
    out = {}
    for name, body in re.findall(r"(\w+)\[\d+\]\s*=\s*\{([^}]*)\}", text):
        out[name] = [int(tok.rstrip("ulUL"), 0) for tok in re.findall(r"0[xX][0-9a-fA-F]+[uUlL]*|\d+", body)]
    return out


def _words(x, n):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def test_keccak_constants_in_cuda_source():
    arrays = _c_arrays("keccak.cu")
    assert arrays["ROUND_CONSTANTS"] == list(ok.ROUND_CONSTANTS)
    assert arrays["ROTATIONS"] == list(ok.ROTATIONS)


def test_field_constants_in_cuda_header():
    arrays = _c_arrays("field.cuh")
    assert arrays["P_WORDS"] == _words(P, 8)
    assert arrays["N_WORDS"] == _words(N, 8)
    assert arrays["CN_WORDS"] == _words((1 << 256) - N, 5)
    assert arrays["BETA_WORDS"] == _words(glv.BETA, 8)
    assert pow(glv.BETA, 3, P) == 1 and pow(glv.LAMBDA, 3, N) == 1


def test_glv_constants_in_cuda_header():
    """The words K6 splits its scalars with in the kernel: lambda, the
    lattice's |b1| and b2, the rounding constants G1, G2 and floor(n / 2),
    against `ops/glv.py`."""
    arrays = _c_arrays("field.cuh")
    assert arrays["LAMBDA_WORDS"] == _words(glv.LAMBDA, 8)
    assert arrays["B1ABS_WORDS"] == _words(glv._B1_ABS, 8)
    assert arrays["B2_WORDS"] == _words(glv._B2, 8)
    assert arrays["G1_WORDS"] == _words(glv._G1, 8)
    assert arrays["G2_WORDS"] == _words(glv._G2, 8)
    assert arrays["HALF_N_WORDS"] == _words(N // 2, 8)
    assert glv._G2 < (1 << 256) and glv._G1 < (1 << 256)  # 8 words hold them


def test_glv_window_count_in_cuda_source():
    with open(os.path.join(CSRC, "msm_small.cu")) as fh:
        m = re.search(r"GLV_WINDOWS\s*=\s*(\d+)", fh.read())
    assert int(m.group(1)) == glv.GLV_WINDOWS
