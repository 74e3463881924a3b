"""Batched Merlin/STROBE-128 transcript, statically scheduled (PyTorch).

Counterpart of `bppp_tpu/transcript/device.py`. Every label, length
prefix, framing byte and operation boundary in the BP++ transcript is
*static* — only point encodings and challenge bytes are data. So this
transcript mirrors the byte-exact STROBE-128 machine (host twin:
`bppp_tpu_torch.oracle.strobe` / `.merlin`) while tracking `pos` /
`pos_begin` / `cur_flags` as Python ints. What runs on tensors is just
constant XORs at static offsets, slice reads and Keccak-f[1600]
permutations, all vectorized over the proof batch.

    t = Transcript(b"u64 range proof", batch=(B,), device="cuda")
    t.append_message(b"reciprocal_commitment", v_bytes)   # (33, B) int64
    e = t.challenge_scalar(b"reciprocal_challenge")        # (16, B) F_n limbs

The state tensor is updated in place where a message is absorbed.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..oracle.strobe import FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M, STROBE_R
from ..ops import field as f
from .keccak import f1600_bytes

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    def __init__(self, label: bytes, batch: tuple = (), device="cuda"):
        # The prefix up to the first data byte is fully static: replay it
        # on the host oracle and lift the resulting state.
        from ..oracle.merlin import Transcript as HostTranscript

        ht = HostTranscript(label)
        s = np.frombuffer(bytes(ht.strobe.state), dtype=np.uint8).astype(np.int64)
        self.batch = tuple(batch)
        self.device = torch.device(device)
        self.state = (
            torch.from_numpy(s)
            .to(self.device)
            .reshape((200,) + (1,) * len(self.batch))
            .expand((200,) + self.batch)
            .contiguous()
        )
        self.pos: int = ht.strobe.pos
        self.pos_begin: int = ht.strobe.pos_begin
        self.cur_flags: int = ht.strobe.cur_flags

    # -- low-level sponge ----------------------------------------------

    def _xor_static(self, offset: int, vals) -> None:
        pad = torch.tensor(list(vals), dtype=torch.int64, device=self.device)
        self.state[offset : offset + len(vals)] ^= pad.reshape(
            (len(vals),) + (1,) * len(self.batch)
        )

    def _run_f(self) -> None:
        self._xor_static(self.pos, [self.pos_begin, 0x04])
        self._xor_static(STROBE_R + 1, [0x80])
        self.state = f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb_static(self, data: bytes) -> None:
        i = 0
        while i < len(data):
            k = min(len(data) - i, STROBE_R - self.pos)
            self._xor_static(self.pos, data[i : i + k])
            self.pos += k
            i += k
            if self.pos == STROBE_R:
                self._run_f()

    def _absorb_data(self, data) -> None:
        """data: (n, *batch) int64 byte tensor."""
        n = data.shape[0]
        i = 0
        while i < n:
            k = min(n - i, STROBE_R - self.pos)
            self.state[self.pos : self.pos + k] ^= data[i : i + k]
            self.pos += k
            i += k
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int):
        """-> (n, *batch) int64 bytes; zeroes the squeezed positions."""
        outs = []
        got = 0
        while got < n:
            k = min(n - got, STROBE_R - self.pos)
            outs.append(self.state[self.pos : self.pos + k].clone())
            self.state[self.pos : self.pos + k] = 0
            self.pos += k
            got += k
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def _begin_op(self, flags: int) -> None:
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb_static(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- STROBE ops ------------------------------------------------------

    def meta_ad(self, data: bytes) -> None:
        self._begin_op(FLAG_M | FLAG_A)
        self._absorb_static(data)

    def _meta_ad_more(self, data: bytes) -> None:
        assert self.cur_flags == FLAG_M | FLAG_A
        self._absorb_static(data)

    def ad_data(self, data) -> None:
        self._begin_op(FLAG_A)
        self._absorb_data(data)

    def ad_static(self, data: bytes) -> None:
        self._begin_op(FLAG_A)
        self._absorb_static(data)

    def prf(self, n: int):
        self._begin_op(FLAG_I | FLAG_A | FLAG_C)
        return self._squeeze(n)

    # -- Merlin framing ---------------------------------------------------

    def append_message(self, label: bytes, message) -> None:
        """message: (n, *batch) int64 byte tensor (data) or bytes (static)."""
        self.meta_ad(label)
        if isinstance(message, (bytes, bytearray)):
            self._meta_ad_more(struct.pack("<I", len(message)))
            self.ad_static(bytes(message))
        else:
            self._meta_ad_more(struct.pack("<I", int(message.shape[0])))
            self.ad_data(message)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int):
        self.meta_ad(label)
        self._meta_ad_more(struct.pack("<I", n))
        return self.prf(n)

    def challenge_scalar(self, label: bytes):
        """32 challenge bytes -> F_n limbs. The value is < 2^256 < 2n, so
        one conditional subtract gives the canonical scalar."""
        buf = self.challenge_bytes(label, 32)
        limbs = f.be_bytes_to_limbs(buf)
        return f._cond_sub(limbs, f.N_LIMBS)
