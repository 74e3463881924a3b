"""What the drivers share: a closed loop of whole batches, and the
reference's verdicts on u64 verify lanes."""

from __future__ import annotations

import numpy as np

from . import lanes, refjobs, runner, traffic


class ClosedLoop:
    """A driver whose window runs whole batches back to back. Subclasses
    set `kind`, `rate_metric`, and define make_inputs, setup, step, check."""

    kind = ""
    rate_metric = ""
    warm_batches = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.wl = ctx.workload
        self.B = int(self.wl["batch"])
        self.trace_batches = int(self.wl.get("trace_batches", 2))

    def window(self, step, seconds: float) -> dict:
        outs, ends = runner.closed_loop(step, seconds)
        return {"outs": outs, "seconds": ends[-1], "batches": len(outs),
                "batch_s": np.diff([0.0] + ends).tolist()}

    def end_to_end(self, win: dict) -> dict:
        return {self.rate_metric: self.B * win["batches"] / win["seconds"]}

    def extra(self, win) -> dict:
        if win is None:
            return {}
        bs = win["batch_s"]
        return {"window": {"batches": win["batches"], "seconds": win["seconds"], "batch": self.B,
                           "first_batch_s": bs[0], "median_batch_s": float(np.median(bs)),
                           "max_batch_s": max(bs), "batch_s": bs}}


class U64Verify(ClosedLoop):
    """Honest u64 proofs made by the reference from the seed, tiled over
    the lanes, with lanes spoiled as the workload says."""

    kind = "verify"

    def make_inputs(self) -> None:
        import torch

        ctx, wl = self.ctx, self.wl
        pr = wl["proofs"]
        self.distinct = int(pr["distinct"])
        values = traffic.u64_values(ctx.seed, self.distinct, pr.get("fixed_values", ()))
        self.honest = refjobs.run(
            "u64_honest_proof", [(ctx.seed_str, ctx.label, x, i) for i, x in enumerate(values)])
        orig = lanes.tile(lanes.to_arrays(self.honest), self.B)
        arrs = {k: v.copy() for k, v in orig.items()}
        self.plan = traffic.tamper_plan(ctx.seed, self.B, int(wl["tamper"]["per_lanes"]))
        for lane, kind in self.plan:
            traffic.apply_tamper(arrs, lane, kind, self.distinct, orig)
        self.arrs = arrs
        self.tensors = {k: torch.from_numpy(v).to(ctx.device) for k, v in arrs.items()}

    def expected(self) -> np.ndarray:
        """The reference's verdict on every lane of a batch."""
        ctx = self.ctx
        jobs = [(ctx.seed_str, ctx.label, ln) for ln in self.honest]
        jobs += [(ctx.seed_str, ctx.label, lanes.lane_at(self.arrs, b)) for b, _ in self.plan]
        verdicts = refjobs.run("u64_verdict", jobs)
        want = np.array([verdicts[b % self.distinct] for b in range(self.B)], dtype=bool)
        for (b, _), v in zip(self.plan, verdicts[self.distinct:]):
            want[b] = v
        return want


class Prove(ClosedLoop):
    """A prover's closed loop: every batch's wire tensors stay on the card
    until the window has closed; the check holds a sample of lanes, drawn
    from the seed, against the reference in every batch."""

    kind = "prove"
    rate_metric = "proves_per_s"
    ref_job = ""

    def sample(self) -> list:
        chk = self.wl["check"]
        return traffic.sample_lanes(self.ctx.seed, self.B, int(chk["sample_lanes"]),
                                    chk.get("fixed_lanes", ()))

    def ref_args(self, lanes_: list) -> list:
        raise NotImplementedError

    def check(self, outs, win) -> tuple:
        import torch

        idx = self.sample()
        want = refjobs.run(self.ref_job, self.ref_args(idx))
        at = torch.tensor(idx, device=self.ctx.device)
        wrong = 0
        for out in outs:
            got = {k: v.index_select(-1, at).cpu().numpy() for k, v in out.items()}
            for j, ref in enumerate(want):
                lane = lanes.lane_at(got, j)
                wrong += int(any(lane[k] != ref[k] for k in ref))
        return [("wrong_proofs", wrong, 0)], len(outs) * self.B, wrong


def limbs_to_ints(a) -> list:
    """(16, ...) int64 limbs (numpy) -> Python ints, flattened in C order
    over the remaining axes."""
    a = np.asarray(a).reshape(16, -1)
    return [sum(int(a[i, j]) << (16 * i) for i in range(16)) for j in range(a.shape[1])]


def ints_to_limbs(vals) -> np.ndarray:
    return np.array([[(int(v) >> (16 * i)) & 0xFFFF for v in vals] for i in range(16)],
                    dtype=np.int64)
