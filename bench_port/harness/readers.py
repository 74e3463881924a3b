"""Helpers of the per-layer metric readers (`metrics/<name>.py`).

A reader gets the run's measurements: `kind` (the driver's: "verify",
"prove", "stream"), `kernel_load_s`, `fixture_s`, and in a traced run
`trace` (what `trace.profile_batches` found) and `bound_s_per_batch` (the
hand-written launches' bounds by `metrics/_work.py`). It returns a number,
or None where it finds nothing to read: the metric is then left out.
"""

from __future__ import annotations


def traced(m: dict, kind: str):
    """The trace of a run of driver kind `kind`, else None."""
    if m.get("kind") != kind:
        return None
    return m.get("trace")


def launches_per_batch(m: dict, kind: str):
    t = traced(m, kind)
    return None if t is None else t["launches_per_batch"]


def eager_device_ms(m: dict, kind: str):
    t = traced(m, kind)
    return None if t is None else t["eager_s_per_batch"] * 1e3


def hand_written_roofline(m: dict, kind: str):
    t = traced(m, kind)
    if t is None or not t["hand_written_s_per_batch"] or "bound_s_per_batch" not in m:
        return None
    return 100.0 * m["bound_s_per_batch"] / t["hand_written_s_per_batch"]


def device_idle_share(m: dict, kind: str):
    t = traced(m, kind)
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
