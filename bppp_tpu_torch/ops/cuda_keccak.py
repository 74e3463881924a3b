"""Keccak-f[1600] on a byte-per-element sponge state: CUDA kernel K1.

Counterpart of `bppp_tpu/ops/pallas_keccak.py`. The state is a
(200, *batch) int64 tensor holding one byte per element, batch axis last,
so that STROBE's byte-position logic stays trivial. On a CUDA tensor the
wrapper narrows to int32 storage, launches the kernel of
`csrc/keccak.cu` on the current stream and widens the result, without
synchronising, for any batch size; on a CPU tensor — and only there — it
runs the plain PyTorch version below.

Replaces: `pallas_keccak._f1600_kernel` (`f1600_flat`).
Bound on an H100: bytes — a lane moves 2 * 200 words and does about
3,600 64-bit logic operations. The kernel keeps the 25 lanes of one
sponge in one thread's registers as `uint64_t` (no lo/hi split) for all
24 rounds, so memory is touched once on the way in and once on the way
out. Kernel and plain version agree byte for byte.
"""

from __future__ import annotations

import ctypes

import torch

from ..oracle.keccak import ROTATIONS, ROUND_CONSTANTS
from . import _build
from .cuda_curve import flat_i32

_VP = _build.VP

LAUNCHES = {"f1600": 0}
PLAIN_CALLS = {"f1600": 0}

_M32 = 0xFFFFFFFF

# pi permutation: dst[y + 5*((2x+3y)%5)] = src[x + 5y]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y

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


def f1600(state):
    """(200, *batch) int64 byte state -> permuted byte state."""
    if not state.is_cuda:
        return f1600_plain(state)
    if state.shape[0] != 200:
        raise ValueError(f"state must have 200 bytes on axis 0, got {tuple(state.shape)}")
    flat = flat_i32(state, state.shape)
    B = flat.shape[1]
    out = torch.empty((200, B), dtype=torch.int32, device=state.device)
    fn = _build.bind("keccak", "bppp_f1600", [_VP, _VP, ctypes.c_int, _VP])
    err = fn(flat.data_ptr(), out.data_ptr(), B, _build.stream())
    LAUNCHES["f1600"] += 1
    _build.check(err, "f1600")
    return out.to(torch.int64).reshape(state.shape)
