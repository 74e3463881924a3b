"""Reading torch.profiler traces of whole batches.

`profile_batches` runs a fixed number of batches under the profiler with
device activity only (what the card did, at little cost to the host) and
reduces the trace to: the traced window's seconds on the host clock, the
seconds in which some operation ran on the card (the union of their
intervals), the device operations per batch, device seconds by operation
name, and the hand-written kernels' share. `idle_gaps` runs one more batch
with host activity too and names each gap on the card by the innermost
host operation running at its middle. A trace with no device event is an
error, never an idle share of 100 %.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict


class NoDeviceEvents(RuntimeError):
    pass


def _is_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def _intervals(events):
    return sorted((e.time_range.start, e.time_range.end) for e in events)


def _union(iv):
    """Merged (start, end) intervals, in microseconds."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def is_hand_written(name: str, hand_written: frozenset) -> bool:
    """Whether a device operation's name, demangled or mangled, names one
    of the port's `__global__` functions."""
    return any(re.search(rf"(?<!\w){re.escape(h)}(?!\w)", name) or f"_Z{len(h)}{h}" in name
               for h in hand_written)


def profile_batches(fn, batches: int, hand_written: frozenset) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [fn() for _ in range(batches)]
        sync()
        window_s = time.perf_counter() - t0
    out = reduce_trace(prof.events(), window_s, batches, hand_written)
    out["outs"] = outs
    return out


def reduce_trace(events, window_s: float, batches: int, hand_written: frozenset) -> dict:
    """A profiler's events over `batches` whole batches -> the trace's numbers."""
    dev = [e for e in events if _is_device(e)]
    if not dev:
        raise NoDeviceEvents("the profiler recorded no device event in the traced batches")
    busy_us = sum(b - a for a, b in _union(_intervals(dev)))
    by_name = defaultdict(float)
    hand_by_name = defaultdict(float)
    kernels = 0
    for e in dev:
        s = (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name] += s
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
    for name, s in by_name.items():
        if is_hand_written(name, hand_written):
            hand_by_name[name] += s
    hand_s = sum(hand_by_name.values())
    device_s = sum(by_name.values())
    return dict(
        batches=batches, window_s=window_s, busy_s=busy_us / 1e6,
        launches_per_batch=kernels / batches,
        device_s_per_batch=device_s / batches,
        hand_written_s_per_batch=hand_s / batches,
        eager_s_per_batch=(device_s - hand_s) / batches,
        by_name=dict(by_name), hand_by_name=dict(hand_by_name),
    )


def idle_gaps(fn, top: int = 10) -> list:
    """[[host operation, seconds]]: the card's idle time in one batch, summed
    by the innermost host operation running at each gap's middle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = _union(_intervals([e for e in events if _is_device(e)]))
    if not dev:
        raise NoDeviceEvents("the profiler recorded no device event in the batch")
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _is_device(e)), key=lambda t: t[0])
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(dev, dev[1:]):
        mid = (end + nxt) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += (nxt - end) / 1e6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(by_name: dict, top: int = 10) -> list:
    return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
