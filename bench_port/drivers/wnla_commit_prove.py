"""Closed loop of the standalone WNLA prover: `WNLADevice.commit(l, n)`
and `prove` over a batch of instances that share the generators, each lane
its own c, rho (mu = rho^2), l and n from the seed, then to wire bytes on
the card (`convert.wnla_dev_to_bytes`, `curve.compress`)."""

from __future__ import annotations

import torch

from bench_port.harness import program, traffic
from bench_port.harness.base import Prove, ints_to_limbs, limbs_to_ints
from bench_port.reference import instances
from bench_port.reference.field import fn_mul


class Driver(Prove):
    ref_job = "wnla_commit_prove"

    def make_inputs(self) -> None:
        ctx, B = self.ctx, self.B
        dims = ctx.config["dims"]
        self.sz_l, self.sz_n = int(dims["l"]), int(dims["n"])
        self.gens = instances.wnla_generators(ctx.seed_str, self.sz_l, self.sz_n)
        gen = traffic.torch_generator(ctx.seed, ctx.device, "wnla prove")
        self.c = traffic.device_scalars(gen, (self.sz_l, B), ctx.device)
        self.rho = traffic.device_scalars(gen, (B,), ctx.device)
        self.l = traffic.device_scalars(gen, (self.sz_l, B), ctx.device)
        self.n = traffic.device_scalars(gen, (self.sz_n, B), ctx.device)
        rho = limbs_to_ints(self.rho.cpu().numpy())
        # the control breaks mu = rho^2: the program is given mu = rho
        mu = rho if ctx.control else [fn_mul(r, r) for r in rho]
        self.mu = torch.from_numpy(ints_to_limbs(mu)).to(ctx.device)

    def setup(self) -> None:
        from bppp_tpu_torch.ops import curve as dcv
        from bppp_tpu_torch.ops.fixed_base import build_tables
        from bppp_tpu_torch.protocol import convert as cv
        from bppp_tpu_torch.protocol.wnla import WNLADevice

        ctx, B = self.ctx, self.B
        g, g_vec, h_vec = self.gens
        tab = None
        if ctx.device.startswith("cuda"):
            tab = build_tables(dcv.from_int_points([g] + h_vec + g_vec, device=ctx.device))
        self.dev = WNLADevice(
            g=cv.point_batched(g, B, device=ctx.device),
            g_vec=cv.points_batched(g_vec, B, device=ctx.device),
            h_vec=cv.points_batched(h_vec, B, device=ctx.device),
            c_vec=self.c, rho=self.rho, mu=self.mu, tables=tab)

    def step(self):
        from bppp_tpu_torch.transcript.device import Transcript

        ctx = self.ctx
        com = self.dev.commit(self.l, self.n)
        proof = self.dev.prove(com, Transcript(ctx.label, batch=(self.B,), device=ctx.device),
                               self.l, self.n)
        out = program.wnla_wire(com, proof)
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        return out

    def ref_args(self, idx: list) -> list:
        at = torch.tensor(idx, device=self.ctx.device)
        c, l, n = (t.index_select(-1, at).cpu().numpy() for t in (self.c, self.l, self.n))
        rho = limbs_to_ints(self.rho.index_select(-1, at).cpu().numpy())
        return [(self.ctx.seed_str, self.ctx.label, limbs_to_ints(c[:, :, j]), rho[j],
                 limbs_to_ints(l[:, :, j]), limbs_to_ints(n[:, :, j])) for j in range(len(idx))]
