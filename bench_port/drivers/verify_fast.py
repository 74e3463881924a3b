"""Closed loop of `U64RangeProofDevice.verify(..., fast=True)`: the
collapsed one-MSM verifier over a batch of wire-form u64 range proofs,
each batch ending when its accept mask is on the host."""

from __future__ import annotations

import numpy as np

from bench_port.harness.base import U64Verify
from bench_port.harness import program


class Driver(U64Verify):
    rate_metric = "verifies_per_s"

    def setup(self) -> None:
        from bppp_tpu_torch.models import u64_fixture

        ctx = self.ctx
        tables = "auto" if ctx.device.startswith("cuda") else "never"
        _, self.dev, _ = u64_fixture(ctx.seed_str, self.B, device=ctx.device, tables=tables)
        self.cb, self.pb = program.u64_proof_bytes(self.tensors)

    def step(self):
        from bppp_tpu_torch.transcript.device import Transcript

        ctx = self.ctx
        t = Transcript(ctx.label, batch=(self.B,), device=ctx.device)
        mask = self.dev.verify(self.cb, t, self.pb, fast=True).cpu()
        if ctx.control:  # a verifier that skips its final check
            mask = mask | True
        return mask

    def check(self, outs, win) -> tuple:
        want = self.expected()
        got = np.stack([np.asarray(m, dtype=bool) for m in outs])
        wrong = int((got != want[None, :]).sum())
        n = got.size
        return [("wrong_verdicts", wrong, 0)], n, wrong
