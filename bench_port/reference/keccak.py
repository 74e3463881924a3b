"""Keccak-f[1600] permutation, host oracle (pure Python).

Underlies the Merlin/STROBE-128 transcript (reference: merlin v3.0.0 ->
keccak 0.1.5 in the Rust reference: Cargo.lock; see SURVEY.md §2 row 12).
State is a list of 25 64-bit lanes, mapped to/from bytes little-endian
per lane (standard Keccak convention).
"""

MASK64 = (1 << 64) - 1

ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets indexed by lane (x + 5*y)
ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK64


def f1600(lanes: list[int]) -> list[int]:
    """One full Keccak-f[1600] permutation over 25 u64 lanes."""
    a = list(lanes)
    for rc in ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # pi: B[y, 2x+3y] = rot(A[x, y], r[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], ROTATIONS[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & MASK64
                    & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def bytes_to_lanes(state: bytes) -> list[int]:
    assert len(state) == 200
    return [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]


def lanes_to_bytes(lanes: list[int]) -> bytes:
    return b"".join(v.to_bytes(8, "little") for v in lanes)


def f1600_bytes(state: bytes) -> bytes:
    return lanes_to_bytes(f1600(bytes_to_lanes(state)))
