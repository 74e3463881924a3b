"""Open loop of the fast u64 verifier: proofs arrive one by one on a
Poisson schedule drawn from the seed, at the rate the workload fixes; a
batcher takes every proof that has arrived, up to the largest of the
workload's `buckets`, pads the batch to the next bucket with further
proofs of the pool (the lanes of one batch of the largest size), and runs
`U64RangeProofDevice.verify(..., fast=True)` on the device object of that
size. A proof's latency runs from the time it was due to
the time its verdict is on the host."""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from bench_port.harness import program, traffic
from bench_port.harness.base import U64Verify


TRACE_SECONDS = 5.0  # the arrivals of the one traced pass


class Driver(U64Verify):
    kind = "stream"
    warm_batches = 0

    def __init__(self, ctx):
        super().__init__(ctx)
        arr = self.wl["arrivals"]
        self.rate = float(arr["rate_per_s"])
        self.buckets = sorted(int(b) for b in arr["buckets"])
        self.trace_batches = 1

    def make_inputs(self) -> None:
        super().make_inputs()
        # the pool twice over, so that any run of lanes from any start is one slice
        self.tensors = {k: torch.cat([v, v], dim=-1) for k, v in self.tensors.items()}

    def setup(self) -> None:
        from bppp_tpu_torch.models import u64_fixture
        from bppp_tpu_torch.ops.curve import PointJ
        from bppp_tpu_torch.protocol.u64 import U64RangeProofDevice

        ctx = self.ctx
        tables = "auto" if ctx.device.startswith("cuda") else "never"
        top = self.buckets[-1]
        _, dev, _ = u64_fixture(ctx.seed_str, top, device=ctx.device, tables=tables)

        def cut(p, n):
            return PointJ(*(c[..., :n].contiguous() for c in p))

        self.devs = {n: dev if n == top else U64RangeProofDevice(
            g=cut(dev.g, n), g_vec=cut(dev.g_vec, n), h_vec=cut(dev.h_vec, n), tables=dev.tables)
            for n in self.buckets}

    def warm(self) -> None:
        for n in self.buckets:  # every size the batcher can pick
            self._verify(0, n)

    def _verify(self, start: int, size: int):
        from bppp_tpu_torch.transcript.device import Transcript

        ctx = self.ctx
        part = {k: v[..., start:start + size].contiguous() for k, v in self.tensors.items()}
        cb, pb = program.u64_proof_bytes(part)
        mask = self.devs[size].verify(cb, Transcript(ctx.label, batch=(size,), device=ctx.device),
                                      pb, fast=True).cpu()
        if ctx.control:
            mask = mask | True
        return mask

    def open_loop(self, rate: float, seconds: float, purpose: str = "arrivals") -> dict:
        """Serve a Poisson schedule of `seconds` at `rate`; every proof that
        arrives in it is answered, after its close if need be."""
        arr = traffic.poisson_arrivals(self.ctx.seed, rate, seconds, purpose)
        n = len(arr)
        done = np.zeros(n)
        start_at = np.zeros(n)
        verdicts = np.zeros(n, dtype=bool)
        batches = []
        nxt = 0
        t0 = time.perf_counter()
        while nxt < n:
            now = time.perf_counter() - t0
            if arr[nxt] > now:
                time.sleep(min(arr[nxt] - now, 0.001))
                continue
            k = min(bisect.bisect_right(arr, now) - nxt, self.buckets[-1])
            size = next(b for b in self.buckets if b >= k)
            mask = self._verify(nxt % self.B, size)
            t_done = time.perf_counter() - t0
            done[nxt:nxt + k] = t_done
            start_at[nxt:nxt + k] = now
            verdicts[nxt:nxt + k] = mask[:k].numpy()
            batches.append((k, size))
            nxt += k
        lat_ms = (done - arr) * 1e3
        return {"outs": [dict(verdicts=verdicts, first=0)], "arrivals": arr, "latency_ms": lat_ms,
                "queue_ms": (start_at - arr) * 1e3, "batches": batches,
                "seconds": time.perf_counter() - t0}

    def window(self, step, seconds: float) -> dict:
        return self.open_loop(self.rate, seconds)

    def step(self):
        """One traced pass: a fixed schedule of `TRACE_SECONDS`."""
        return self.open_loop(self.rate, TRACE_SECONDS, "trace arrivals")["outs"][0]

    def one_batch(self):
        """A batch of the largest size: what the traced run's host gaps read."""
        return self._verify(0, self.buckets[-1])

    def end_to_end(self, win: dict) -> dict:
        lat = win["latency_ms"]
        return {"verify_latency_ms_p95": float(np.quantile(lat, 0.95))} if len(lat) else {}

    def extra(self, win) -> dict:
        if win is None:
            return {}
        lat, q = win["latency_ms"], win["queue_ms"]
        return {"stream": {
            "rate_per_s": self.rate, "proofs": int(len(lat)),
            "latency_ms_p50": float(np.quantile(lat, 0.5)) if len(lat) else None,
            "beyond_p95": int((lat > np.quantile(lat, 0.95)).sum()) if len(lat) else 0,
            "queue_ms_p95": float(np.quantile(q, 0.95)) if len(q) else None,
            "queue_ms_max": float(q.max()) if len(q) else None,
            "batches": len(win["batches"]),
            "mean_batch": float(np.mean([k for k, _ in win["batches"]])) if win["batches"] else 0.0,
            "seconds": win["seconds"]}}

    def check(self, outs, win) -> tuple:
        want = self.expected()
        wrong = 0
        n = 0
        for o in outs:
            v = o["verdicts"]
            idx = (np.arange(len(v)) + o["first"]) % self.B
            wrong += int((v != want[idx]).sum())
            n += len(v)
        return [("wrong_verdicts", wrong, 0)], n, wrong
