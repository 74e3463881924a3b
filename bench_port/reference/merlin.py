"""Merlin transcript, host oracle — bit-exact vs merlin v3.0.0.

Reference usage: src/ of the Rust reference: transcript.rs (append point /
challenge scalar helpers) plus `append_u64` calls in wnla.rs:91-92,165-166.
Framing per merlin: every message/challenge is

    meta-AD( label || LE32(len) );  AD( message )   (append)
    meta-AD( label || LE32(len) );  PRF( len )      (challenge)

and transcript construction is STROBE-128("Merlin v1.0") followed by
append_message(b"dom-sep", app_label).
"""

from __future__ import annotations

import struct

from .strobe import Strobe128
from .field import scalar_from_be_bytes
from .curve import Point

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        data_len = struct.pack("<I", len(message))
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = struct.pack("<I", n)
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)


# -- bp-pp transcript helpers (reference: src/transcript.rs:6-14) -------

def app_point(label: bytes, p: Point, t: Transcript) -> None:
    t.append_message(label, p.to_bytes())


def get_challenge(label: bytes, t: Transcript) -> int:
    buf = t.challenge_bytes(label, 32)
    return scalar_from_be_bytes(buf)
