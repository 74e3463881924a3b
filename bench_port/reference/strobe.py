"""STROBE-128 duplex construction, host oracle.

Bit-exact re-implementation of merlin v3.0.0's internal `Strobe128`
(reference dependency: the Rust reference: Cargo.toml:17; SURVEY.md §2 row 12
and the transcript byte-layout contract in SURVEY.md §2). Only the subset
of STROBE that Merlin uses is implemented: meta-AD, AD, PRF, KEY.

Security level 128 -> sponge rate R = 200 - 2*16 - 2 = 166 bytes.
"""

from .keccak import f1600_bytes

STROBE_R = 166

FLAG_I = 1 << 0
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        state = bytearray(200)
        # F(pad || "STROBEv1.0.2"): domain-separation preamble
        state[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 12 * 8])
        state[6:18] = b"STROBEv1.0.2"
        self.state = bytearray(f1600_bytes(bytes(state)))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- low-level sponge ops -----------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = bytearray(f1600_bytes(bytes(self.state)))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continued operation")
            return
        if flags & FLAG_T:
            raise ValueError("transport flags not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- STROBE operations used by Merlin ------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)
