"""K1's thread schedule on the CPU: the per-thread constants written into
`csrc/keccak.cu` equal `cuda_keccak.thread_constants()`, which follows
from `oracle/keccak.py`'s tables, and a numpy run of the kernel's
schedule from those constants — 25 threads per sponge, word-major blocks
of lpb sponges, the shared buffers of words and column parities, a ragged
last block — gives the host
oracle's and the JAX package's Keccak-f[1600] byte for byte (tolerance 0).
`f1600_plan` gives blocks of whole warps that cover any batch."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from bppp_tpu.transcript import keccak as jk
from bppp_tpu_torch.ops import cuda_keccak
from bppp_tpu_torch.oracle import keccak as ok

CSRC = os.path.join(os.path.dirname(__file__), "..", "bppp_tpu_torch", "csrc")
K = cuda_keccak.thread_constants()


def c_arrays(filename):
    """{name: [ints]} for every `NAME[k] = { ... }` initializer of a source."""
    with open(os.path.join(CSRC, filename)) as fh:
        text = fh.read()
    return {name: [int(tok.rstrip("ulUL"), 0) for tok in re.findall(r"0[xX][0-9a-fA-F]+[uUlL]*|\d+", body)]
            for name, body in re.findall(r"(\w+)\[\d+\]\s*=\s*\{([^}]*)\}", text)}


def c_constant(filename, name):
    with open(os.path.join(CSRC, filename)) as fh:
        return int(re.search(rf"{name}\s*=\s*(\d+)", fh.read()).group(1))


def test_thread_constants_in_cuda_source():
    arrays = c_arrays("keccak.cu")
    for name, vals in K.items():
        assert arrays[name] == vals, name
    assert arrays["ROUND_CONSTANTS"] == list(ok.ROUND_CONSTANTS)


def test_thread_constants_follow_from_the_oracle_tables():
    """Word w = x + 5 y: its rho rotation is the oracle's, pi moves it to
    y + 5 ((2x + 3y) mod 5) as the oracle's rounds do, and that is a
    permutation; theta reads columns x -+ 1 and chi the row's x + 1, x + 2."""
    assert K["ROTATIONS"] == list(ok.ROTATIONS)
    assert sorted(K["W_PI"]) == list(range(25))
    for w in range(25):
        x, y = w % 5, w // 5
        assert K["W_PI"][w] == y + 5 * ((2 * x + 3 * y) % 5)
        assert (K["W_THETA_L"][w], K["W_THETA_R"][w]) == ((x - 1) % 5, (x + 1) % 5)
        assert (K["W_CHI1"][w], K["W_CHI2"][w]) == ((x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y)


def rotl(v, n):
    """The kernel's rotate: (v << n) | (v >> ((64 - n) & 63)), n in 0..63."""
    return (v << n) | (v >> ((np.uint64(64) - n) & np.uint64(63)))


def schedule(state, lpb):
    """The 25-thread kernel's schedule in numpy: (200, B) bytes -> (200, B)
    bytes. Block by block, thread t = w * lpb + s owns word w of sponge s;
    the five threads of row 0 put the column parities in a third buffer;
    threads past the batch run on its last lane and store nothing."""
    cst = {k: np.asarray(v, dtype=np.uint64) for k, v in K.items()}
    rc = np.asarray(ok.ROUND_CONSTANTS, dtype=np.uint64)
    B = state.shape[1]
    out = np.full((200, B), -1, dtype=np.int64)
    t = np.arange(25 * lpb)
    w, s = t // lpb, t % lpb
    rot = cst["ROTATIONS"][w]
    pi, tl, tr, c1, c2 = (cst[k][w].astype(np.int64) for k in ("W_PI", "W_THETA_L", "W_THETA_R",
                                                               "W_CHI1", "W_CHI2"))
    x, s0 = w[w < 5], s[w < 5]  # the threads of row 0: column x of sponge s0
    shifts = np.arange(8, dtype=np.uint64) * np.uint64(8)
    for blk in range(-(-B // lpb)):
        idx = blk * lpb + s
        lane = np.minimum(idx, B - 1)
        byts = state[8 * w[:, None] + np.arange(8)[None], lane[:, None]].astype(np.uint64)
        a = np.bitwise_or.reduce(byts << shifts, axis=1)
        for r in range(24):
            sa = np.empty(25 * lpb, dtype=np.uint64)
            sa[t] = a
            sc = np.empty(5 * lpb, dtype=np.uint64)
            sc[x * lpb + s0] = sa[x * lpb + s0] ^ sa[(x + 5) * lpb + s0] ^ sa[(x + 10) * lpb + s0] \
                ^ sa[(x + 15) * lpb + s0] ^ sa[(x + 20) * lpb + s0]
            a = a ^ sc[tl * lpb + s] ^ rotl(sc[tr * lpb + s], np.uint64(1))
            sb = np.empty(25 * lpb, dtype=np.uint64)
            sb[pi * lpb + s] = rotl(a, rot)
            a = sb[t] ^ (~sb[c1 * lpb + s] & sb[c2 * lpb + s])
            a[w == 0] ^= rc[r]
        live = idx < B
        for k in range(8):
            out[8 * w[live] + k, idx[live]] = ((a[live] >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.int64)
    return out


def states():
    """(200, 6) bytes: all zero, all 0xFF, and four random states."""
    rng = np.random.default_rng(1600)
    cols = [np.zeros(200, dtype=np.int64), np.full(200, 0xFF, dtype=np.int64)]
    cols += [rng.integers(0, 256, size=200) for _ in range(4)]
    return np.stack(cols, axis=1)


STATES = states()
ORACLE = np.stack([np.frombuffer(ok.f1600_bytes(bytes(STATES[:, j].tolist())), dtype=np.uint8)
                   for j in range(STATES.shape[1])], axis=1).astype(np.int64)


def test_oracle_agrees_with_the_jax_package():
    want = np.asarray(jk.f1600_bytes(jnp.asarray(STATES.astype(np.uint32)))).astype(np.int64)
    assert np.array_equal(want, ORACLE)


@pytest.mark.parametrize("lpb", [1, 4, 8, 32])
def test_schedule_gives_the_oracle_permutation(lpb):
    """Six sponges in blocks of lpb: whole blocks, a ragged last block
    (lpb = 4, 32) and one sponge per block."""
    assert np.array_equal(schedule(STATES, lpb), ORACLE)


@pytest.mark.parametrize("B", [1, 2, 31, 77, 1024, 4096, 8192, 8193, 16384, 16385])
def test_f1600_plan_gives_whole_warps(B):
    """25 threads per sponge up to K1_LANE_ABOVE lanes, within the kernel's
    limit of MAX_LPB sponges a block, one thread per sponge beyond; blocks
    of whole warps within 1024 threads; ceil(B / lpb) blocks hold every
    sponge and no block is empty."""
    nthr, lpb = cuda_keccak.f1600_plan(B)
    assert nthr == (1 if B > cuda_keccak.K1_LANE_ABOVE else 25)
    threads = cuda_keccak.threads_per_block(nthr, lpb)
    assert threads % 32 == 0 and nthr * lpb <= threads < nthr * lpb + 32 and threads <= 1024
    if nthr == 25:
        assert 1 <= lpb <= c_constant("keccak.cu", "MAX_LPB")
    blocks = -(-B // lpb)
    assert blocks * lpb >= B > (blocks - 1) * lpb
