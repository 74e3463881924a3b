"""Closed loop of the u64 prover: `U64RangeProofDevice.commit_value` and
`prove` over a batch, each lane its own value, blinding and 52 draws from
the seed, then to wire bytes on the card (`convert.reciprocal_dev_to_bytes`,
`curve.compress`)."""

from __future__ import annotations

import torch

from bench_port.harness import program, traffic
from bench_port.harness.base import Prove, limbs_to_ints

BLIND_DRAWS = 52


class Driver(Prove):
    ref_job = "u64_prove"

    def make_inputs(self) -> None:
        ctx, B = self.ctx, self.B
        gen = traffic.torch_generator(ctx.seed, ctx.device, "u64 prove")
        x = torch.randint(0, 1 << 32, (2, B), generator=gen, device=ctx.device, dtype=torch.int64)
        for b, v in enumerate(self.wl.get("fixed_values", ())[:B]):
            x[0, b], x[1, b] = int(v) & 0xFFFFFFFF, int(v) >> 32
        self.x_words = x
        self.s = traffic.device_scalars(gen, (B,), ctx.device)
        self.blind = traffic.device_scalars(gen, (BLIND_DRAWS, B), ctx.device)
        if ctx.control:  # each lane proves with its neighbour's draws
            self.blind_used = torch.roll(self.blind, 1, dims=-1)
        else:
            self.blind_used = self.blind

    def setup(self) -> None:
        from bppp_tpu_torch.models import u64_fixture

        ctx = self.ctx
        tables = "auto" if ctx.device.startswith("cuda") else "never"
        _, self.dev, _ = u64_fixture(ctx.seed_str, self.B, device=ctx.device, tables=tables)

    def step(self):
        from bppp_tpu_torch.transcript.device import Transcript

        ctx = self.ctx
        com = self.dev.commit_value(self.x_words, self.s)
        proof = self.dev.prove(self.x_words, self.s,
                               Transcript(ctx.label, batch=(self.B,), device=ctx.device),
                               self.blind_used)
        out = program.u64_wire(com, proof)
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        return out

    def ref_args(self, idx: list) -> list:
        at = torch.tensor(idx, device=self.ctx.device)
        xw = self.x_words.index_select(-1, at).cpu().numpy()
        s = limbs_to_ints(self.s.index_select(-1, at).cpu().numpy())
        blind = self.blind.index_select(-1, at).cpu().numpy()  # (16, 52, n)
        out = []
        for j in range(len(idx)):
            x = int(xw[0, j]) | int(xw[1, j]) << 32
            out.append((self.ctx.seed_str, self.ctx.label, x, s[j], limbs_to_ints(blind[:, :, j])))
        return out
