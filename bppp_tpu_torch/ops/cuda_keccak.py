"""Keccak-f[1600] on a byte-per-element sponge state: CUDA kernel K1.

Counterpart of `bppp_tpu/ops/pallas_keccak.py`. The state is a
(200, *batch) int64 tensor holding one byte per element, batch axis last,
so that STROBE's byte-position logic stays trivial. On a CUDA tensor the
wrapper launches the kernel of `csrc/keccak.cu` on the current stream,
without synchronising, for any batch size: the kernel reads the int64
bytes where they lie (a byte stride and a lane stride, `cuda_curve.lane_view`)
and writes a new int64 state, so a call is one launch. On a CPU tensor —
and only there — it runs the plain PyTorch version below.

Replaces: `pallas_keccak._f1600_kernel` (`f1600_flat`).
Bound on an H100: bytes — a lane moves 2 * 200 int64 bytes and does
about 24 * 216 64-bit logic operations. At the paths' 1,024 lanes the
24 rounds of a sponge are a series, so the kernel shares each sponge
among 25 threads, one 64-bit word each, exchanging words through shared
memory with three block barriers per round (`thread_constants` says which
thread reads which word). Where the batch fills the card the shared
traffic costs more than the series, and one thread per sponge, its words
in registers, is faster: `f1600_plan` chooses from the sweep of both on
the card. Kernel and plain version agree byte for byte.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..oracle.keccak import ROTATIONS, ROUND_CONSTANTS
from . import _build
from .cuda_curve import lane_view

_VP = _build.VP

LAUNCHES = {"f1600": 0}
PLAIN_CALLS = {"f1600": 0}

_M32 = 0xFFFFFFFF


def thread_constants() -> dict:
    """{array name in `csrc/keccak.cu`: 25 values}: what the thread of word
    w = x + 5 y reads and writes in a round. ROTATIONS: rho's rotation of
    the word (the oracle's table); W_PI: the slot pi moves it to, pi
    being B[y, 2x + 3y] = A[x, y]; W_THETA_L / W_THETA_R: the columns
    x - 1 and x + 1 whose parities theta xors in (the second rotated by
    one); W_CHI1 / W_CHI2: the row neighbours x + 1 and x + 2 chi reads."""
    out = {k: [0] * 25 for k in ("ROTATIONS", "W_PI", "W_THETA_L", "W_THETA_R", "W_CHI1", "W_CHI2")}
    for w in range(25):
        x, y = w % 5, w // 5
        out["ROTATIONS"][w] = ROTATIONS[w]
        out["W_PI"][w] = y + 5 * ((2 * x + 3 * y) % 5)
        out["W_THETA_L"][w] = (x + 4) % 5
        out["W_THETA_R"][w] = (x + 1) % 5
        out["W_CHI1"][w] = (x + 1) % 5 + 5 * y
        out["W_CHI2"][w] = (x + 2) % 5 + 5 * y
    return out


# pi permutation as the plain rounds gather it: dst[d] = src[_PI_SRC[d]]
_PI_SRC = [0] * 25
for _w, _d in enumerate(thread_constants()["W_PI"]):
    _PI_SRC[_d] = _w

_TABLES: dict = {}


def _tables(like: torch.Tensor):
    """Per-device constants of the plain rounds, shaped to broadcast
    against a (2, 25, *batch) state."""
    key = (like.device, like.ndim)
    if key not in _TABLES:
        tail = (1,) * (like.ndim - 2)
        dev = like.device
        rot = [ROTATIONS[s] for s in _PI_SRC]
        mk = lambda vals, shape: torch.tensor(vals, dtype=torch.int64, device=dev).reshape(shape)
        _TABLES[key] = dict(
            src=torch.tensor(_PI_SRC, dtype=torch.int64, device=dev),
            swap=mk([r >= 32 for r in rot], (1, 25) + tail).bool(),
            m=mk([r % 32 for r in rot], (1, 25) + tail),
            rc=[
                mk([rc & _M32, rc >> 32], (2,) + tail) for rc in ROUND_CONSTANTS
            ],
        )
    return _TABLES[key]


def pack_bytes(state):
    """(200, *batch) bytes -> ((25, *batch) lo, (25, *batch) hi) 32-bit
    halves, little-endian per 8-byte lane."""
    b = state.reshape((25, 8) + tuple(state.shape[1:]))
    lo = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    hi = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
    return lo, hi


def unpack_bytes(lo, hi):
    """Inverse of pack_bytes -> (200, *batch) bytes."""
    parts = [(h >> s) & 0xFF for h in (lo, hi) for s in (0, 8, 16, 24)]
    b = torch.stack(parts, dim=1)  # (25, 8, *batch)
    return b.reshape((200,) + tuple(lo.shape[1:]))


def _rotl(st, m):
    """Rotate 64-bit lanes held as st[0] = lo, st[1] = hi left by m < 32
    (an int or a broadcastable tensor)."""
    return ((st << m) | (st.flip(0) >> (32 - m))) & _M32


def f1600_lanes(lo, hi):
    """24 rounds over (25, *batch) 32-bit lane halves (int64 storage)."""
    st = torch.stack([lo, hi], dim=0)  # (2, 25, *batch)
    tb = _tables(st)
    tail = tuple(st.shape[2:])
    for rnd in range(24):
        # theta
        s5 = st.reshape((2, 5, 5) + tail)  # [half, y, x]
        c = s5[:, 0] ^ s5[:, 1] ^ s5[:, 2] ^ s5[:, 3] ^ s5[:, 4]  # (2, 5x, *b)
        d = c.roll(1, dims=1) ^ _rotl(c.roll(-1, dims=1), 1)
        st = (s5 ^ d.unsqueeze(1)).reshape((2, 25) + tail)
        # rho + pi
        b = st.index_select(1, tb["src"])
        b = torch.where(tb["swap"], b.flip(0), b)
        b = _rotl(b, tb["m"])
        # chi: rows of 5 along x
        b5 = b.reshape((2, 5, 5) + tail)
        n = b5 ^ ((b5.roll(-1, dims=2) ^ _M32) & b5.roll(-2, dims=2))
        st = n.reshape((2, 25) + tail)
        # iota
        st = torch.cat([st[:, :1] ^ tb["rc"][rnd].unsqueeze(1), st[:, 1:]], dim=1)
    return st[0], st[1]


def f1600_plain(state):
    PLAIN_CALLS["f1600"] += 1
    lo, hi = pack_bytes(state)
    lo, hi = f1600_lanes(lo, hi)
    return unpack_bytes(lo, hi)


# -- the launch ------------------------------------------------------------------

K1_WORDS = 25  # threads per sponge of the shared launch
# The sweep of K1's launches on the H100 (device ms per launch,
# `tools/compare_designs.py`, PERF.md): 25 threads a sponge at 8 sponges a
# block 0.0075 at 1,024 lanes and 0.0110 at 4,096, one thread a sponge
# 0.0117 and 0.0118; at 8,192 one thread 0.0140, 25 threads 0.0188 (0.0162
# at 16 a block); at 16,384 one thread 0.0268 (32 a block), 25 threads
# 0.0340 (16 a block). One warp a sponge (0.0085 at 1,024, 0.083 at
# 16,384) and 25 threads reading both columns for theta (0.0467 at
# 16,384) lost and were deleted.
K1_LPB = 8  # sponges per block of the shared launch: 200 threads, 7 warps
K1_LANE_ABOVE = 4096  # lanes above which one thread a sponge runs
K1_LANE_BLOCK = 32  # threads per block of that launch


def f1600_plan(B: int) -> tuple[int, int]:
    """(threads per sponge, sponges per block) of K1's launch over B
    sponges: 25 threads a sponge, K1_LPB a block, up to K1_LANE_ABOVE lanes;
    one thread a sponge, K1_LANE_BLOCK a block, beyond. Blocks are whole
    warps, and ceil(B / lpb) of them cover a ragged batch."""
    if B > K1_LANE_ABOVE:
        return 1, K1_LANE_BLOCK
    return K1_WORDS, K1_LPB


def threads_per_block(nthr: int, lpb: int) -> int:
    """Threads of a block of lpb sponges at nthr threads per sponge."""
    return -(-nthr * lpb // 32) * 32


def f1600_launch(state, nthr: int, lpb: int):
    """Launch K1 with nthr threads per sponge (25 or 1) and lpb sponges per
    block on a (200, *batch) int64 byte state on the card -> a new (200,
    *batch) int64 state."""
    view, byte_stride, lane_stride = lane_view(state, state.shape)
    out = torch.empty(state.shape, dtype=torch.int64, device=state.device)
    fn = _build.bind("keccak", "bppp_f1600", [_VP, ctypes.c_longlong, ctypes.c_longlong, _VP]
                     + [ctypes.c_int] * 3 + [_VP])
    err = fn(view.data_ptr(), byte_stride, lane_stride, out.data_ptr(),
             math.prod(state.shape[1:]), nthr, lpb, _build.stream())
    LAUNCHES["f1600"] += 1
    _build.check(err, "f1600")
    return out


def f1600(state):
    """(200, *batch) int64 byte state -> permuted byte state, a new tensor.
    One launch: the kernel reads the state where it lies."""
    if not state.is_cuda:
        return f1600_plain(state)
    if state.ndim < 1 or state.shape[0] != 200:
        raise ValueError(f"state must have 200 bytes on axis 0, got {tuple(state.shape)}")
    return f1600_launch(state, *f1600_plan(math.prod(state.shape[1:])))
