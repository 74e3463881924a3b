"""K2's step lists (`bppp_tpu_torch.ops.field.pow_chain`) and the plain
exponentiation that runs them, and the stride helper and launch plan of
K5a's wrapper (`bppp_tpu_torch.ops.cuda_curve`). Exact throughout
(tolerance 0): exponents are integers, limbs are integers. The JAX
package's `fp_inv`, `fp_sqrt` and `fn_inv` are called directly on the CPU."""

import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import field as jf
from bppp_tpu_torch.ops import cuda_curve, cuda_msm
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle.field import N, P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMED = {
    "fp_sqrt": ((P + 1) // 4, P, 253, 13),
    "fp_inv": (P - 2, P, 255, 15),
    "fn_inv": (N - 2, N, 256, 41),
}


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def check_chain(ch, e):
    """The list computes e, reads only slots written before, and fits the
    kernel."""
    written = {0}
    for dst, src, nsqr, mul in ch.steps:
        assert src in written and (mul < 0 or mul in written)
        assert 0 <= dst < ch.slots and 0 <= nsqr < 256
        written.add(dst)
    assert ch.result in written
    assert tf.chain_exponent(ch) == e
    assert len(ch.steps) <= tf.POW_MAX_STEPS and ch.slots <= tf.POW_MAX_SLOTS
    assert ch.squares == sum(s[2] for s in ch.steps)
    assert ch.multiplies == sum(s[3] >= 0 for s in ch.steps)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_chain_computes_its_exponent(name):
    e, _, squares, multiplies = NAMED[name]
    ch = tf.pow_chain(e)
    check_chain(ch, e)
    assert (ch.squares, ch.multiplies) == (squares, multiplies)


@pytest.mark.parametrize("lo", range(1, 257, 32))
def test_window_chain_computes_random_exponents(lo):
    """Random exponents of every bit length from lo to lo + 31, and the
    patterns a sliding window finds hardest (isolated ones, all ones)."""
    rng = random.Random(lo)
    es = [rng.getrandbits(b) | (1 << (b - 1)) for b in range(lo, min(lo + 32, 257))]
    es += [(1 << lo) - 1, 1 << (lo - 1), int("10000" * 52, 2) >> (260 - lo)]
    for e in es:
        if e:
            check_chain(tf.pow_chain(e), e)


def test_pow_chain_rejects_out_of_range_exponents():
    for e in (0, -3, 1 << 256):
        with pytest.raises(ValueError):
            tf.pow_chain(e)


def square_and_multiply(x, e, mul):
    """x^e by the plain binary method, MSB first, on limb tensors."""
    acc = torch.zeros_like(x)
    acc[0] = 1
    for bit in bin(e)[2:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, x)
    return acc


@pytest.fixture(scope="module")
def lanes():
    """x = 0, 1 and a random value, for each modulus."""
    rng = random.Random(20261017)
    return {m: T(tf.ints_to_limbs([0, 1, rng.randrange(2, m)])) for m in (P, N)}


@pytest.mark.parametrize("name", sorted(NAMED) + ["p other", "n other"])
def test_plain_interpreter_equals_square_and_multiply(name, lanes):
    if name in NAMED:
        e, m = NAMED[name][:2]
    else:
        m = P if name[0] == "p" else N
        e = random.Random(name).getrandbits(256) | (1 << 255)
    kind = "p" if m == P else "n"
    mul = tf.fp_mul if m == P else tf.fn_mul
    x = lanes[m]
    got = cuda_msm.pow_const(x, e, kind)
    assert torch.equal(got, square_and_multiply(x, e, mul))
    assert tf.limbs_to_ints(got) == [pow(v, e, m) for v in tf.limbs_to_ints(x)]


@pytest.mark.parametrize("name", sorted(NAMED))
def test_plain_interpreter_equals_the_jax_package(name, lanes):
    e, m = NAMED[name][:2]
    x = lanes[m]
    got = getattr(tf, name)(x)
    want = getattr(jf, name)(jnp.asarray(x.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_packed_steps_round_trip():
    for e in (P - 2, N - 2, 5):
        ch = tf.pow_chain(e)
        words = list(cuda_msm._packed_steps(ch))[: len(ch.steps)]
        back = [(w & 0xFF, (w >> 8) & 0xFF, w >> 24, -1 if (w >> 16) & 0xFF == 0xFF
                 else (w >> 16) & 0xFF) for w in words]
        assert tuple(back) == ch.steps


def test_kernel_limits_match_the_host():
    """csrc/pow.cu takes at most POW_MAX_STEPS steps over POW_MAX_SLOTS
    slots."""
    with open(os.path.join(ROOT, "bppp_tpu_torch", "csrc", "pow.cu")) as fh:
        src = fh.read()
    for name in ("POW_MAX_STEPS", "POW_MAX_SLOTS"):
        got = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert got == getattr(tf, name)


def strides_of(t):
    return cuda_curve.lane_strides(t.shape, t.stride())


@pytest.mark.parametrize("case", ["full", "nd", "broadcast", "one", "slice", "mixed", "transposed"])
def test_lane_strides(case):
    """(limb stride, lane stride) of the operand views K5a and K2 read in
    place, and None where the batch axes do not fold into one."""
    B, L = 6, 3
    full = torch.zeros((16, B), dtype=torch.int64)
    stack = torch.zeros((16, L, B), dtype=torch.int64)
    views = {
        "full": (full, (B, 1)),
        "nd": (torch.zeros((16, 2, 3, 4), dtype=torch.int64), (24, 1)),
        "broadcast": (full[:, :1].expand(16, B), (B, 0)),
        "one": (torch.zeros((16, 1, 1), dtype=torch.int64), (1, 0)),
        "slice": (stack[:, 1], (L * B, 1)),
        "mixed": (full[:, None].expand(16, L, B), None),
        "transposed": (stack.transpose(1, 2), None),
    }
    t, want = views[case]
    assert strides_of(t) == want
    if want is not None:
        # the element each (limb, lane) pair addresses is the view's own
        flat = torch.arange(t.untyped_storage().nbytes() // 8)
        at = torch.as_strided(flat, t.shape, t.stride(), t.storage_offset()).reshape(16, -1)
        assert at.tolist() == [[t.storage_offset() + i * want[0] + b * want[1]
                                for b in range(at.shape[1])] for i in range(16)]


def test_pt_add_plan():
    """4 threads per lane up to the split's threads (the paths' 1024 lanes),
    2 beyond, also where the card fills (the table build's last adds)."""
    cap = cuda_curve.K5A_SPLIT_THREADS
    assert cuda_curve.pt_add_plan(1024) == (4, 32)
    assert cuda_curve.pt_add_plan(cap // 4) == (4, 32)
    assert cuda_curve.pt_add_plan(cap // 4 + 1) == (2, 64)
    assert cuda_curve.pt_add_plan(32 * 49 * 128) == (2, 64)
    for B in (1, 5, 1024, 200704):
        T, lpb = cuda_curve.pt_add_plan(B)
        assert T * lpb == cuda_curve.K5A_BLOCK and T * lpb % 32 == 0
