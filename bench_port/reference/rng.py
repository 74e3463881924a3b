"""Blinding randomness sources.

The reference threads a caller-supplied `RngCore + CryptoRng` through the
prover and draws `Scalar::generate_biased` for every blinding lane
(circuit.rs:264-298, :371-372; reciprocal.rs:121). Here an RNG is any
object with `.scalar() -> int in [0, N)`. Three implementations:

  * OsRng        — os.urandom wide reduction (production prover)
  * SeededRng    — deterministic SHA-256 counter stream (fixtures/tests)
  * ReplayRng    — replays an explicit list (reproducing external fixtures)

## Byte-level draw-stream spec (Rust-interop contract, VERDICT r2 #9)

One scalar draw consumes exactly ONE 64-byte block from the underlying
byte stream, interpreted as a BIG-ENDIAN 512-bit integer and reduced
mod n (the secp256k1 group order). This is value-equivalent to k256
v0.13 `Scalar::generate_biased`, which fills a 64-byte `WideBytes` via
`RngCore::fill_bytes` and wide-reduces it mod n — so a Rust prover and
this prover driven by the SAME 64-byte blocks in the SAME order produce
identical blindings. Caveats for anyone attempting bit-exact prover
interop against the Rust reference:

  * k256's wide reduction is Montgomery-form internally but the RESULT
    equals `int.from_bytes(block, "big") % n`; only the byte-block
    boundary and endianness matter for replay.
  * The reference's tests use `rand::rngs::OsRng`, which is NOT
    reproducible; deterministic fixtures must inject a recorded stream
    on the Rust side (e.g. a `ReplayRng` twin over the same 64-byte
    blocks) — this package's committed fixtures are generated by
    SeededRng below and replayed with ReplayRng.
  * Draw ORDER for the u64 prover (52 draws): r_blind, then the
    circuit's ro(7), rl(6), rr(5), l_s(nv), n_s(nm) —
    protocol/circuit.py `_expand_blind`; must match circuit.rs:264-298,
    :371-372 ordering exactly.
  * Verification never touches the RNG; interop of PROOF JSON needs
    none of this (serde.py pins the k256 serde hex conventions).

SeededRng's stream is NOT a k256 construct: block_i = SHA256(seed ||
LE64(i) || 0x00) || SHA256(seed || LE64(i) || 0x01); it exists so
fixtures are stable across platforms, and ReplayRng can replay its
integer draws into either implementation.
"""

from __future__ import annotations

import hashlib
import os

from .field import N


class OsRng:
    def scalar(self) -> int:
        # 64-byte wide reduction: bias ~2^-256, matching the shape of
        # k256's generate_biased (wide scalar reduced mod N).
        return int.from_bytes(os.urandom(64), "big") % N


class SeededRng:
    """Deterministic stream: scalar_i = SHA256(seed || LE64(i)) * 2 draws,
    64 bytes reduced mod N. Stable across platforms/versions."""

    def __init__(self, seed: bytes | str):
        if isinstance(seed, str):
            seed = seed.encode()
        self.seed = seed
        self.counter = 0

    def scalar(self) -> int:
        h1 = hashlib.sha256(self.seed + self.counter.to_bytes(8, "little") + b"\x00").digest()
        h2 = hashlib.sha256(self.seed + self.counter.to_bytes(8, "little") + b"\x01").digest()
        self.counter += 1
        return int.from_bytes(h1 + h2, "big") % N

    def scalars(self, k: int) -> list[int]:
        return [self.scalar() for _ in range(k)]


class ReplayRng:
    def __init__(self, values: list[int]):
        self.values = list(values)
        self.pos = 0

    def scalar(self) -> int:
        v = self.values[self.pos]
        self.pos += 1
        return v
