"""A run's check sees the faults a cell can have, and the control.

The verify cell drives the port itself on the CPU at 8 lanes (7 of them
spoiled). The prove cells put the reference in the program's place (a
stand-in that proves every lane with the reference, from what the program
was given), so that a run holds a few lanes in seconds; the faults are
planted on top of it. Each run skips the harness's look for a card and
drives the rest of a run. The exchange between cards is no fault of these
cells: each runs on one card.
"""

import numpy as np
import pytest
import torch

from bench_port.harness import lanes, refjobs, registry, runner

SEED = 2**40 + 77


def _small(monkeypatch, B, sample=None):
    orig = registry.workload

    def small(name):
        w = orig(name)
        w["batch"] = B
        if "tamper" in w:
            w["tamper"]["per_lanes"] = B
            w["proofs"]["distinct"] = 2
        if "check" in w:
            w["check"]["sample_lanes"] = sample or B
        return w

    monkeypatch.setattr(registry, "workload", small)


def _run(cell, fault=None, control=False):
    return runner.run(cell, SEED, 0.01, False, device="cpu", fault=fault, control=control)


@pytest.mark.parametrize("kind", ["none", "control", "unchanged", "half_batch", "altered"])
def test_verify_cell_sees_each_fault(monkeypatch, kind):
    _small(monkeypatch, 8)
    out = _run("u64.verify_fast.b16384", fault=None if kind in ("none", "control") else kind,
               control=kind == "control")
    assert out["correct"] is (kind == "none"), out["checks"]
    assert list(out)[-1] == "checks"


def _standin(drv, job, args_of):
    """Replace the driver's step by the reference run on what the program
    was given, lane by lane."""
    memo = {}

    def step():
        if "out" not in memo:
            got = refjobs.run(job, args_of(drv))
            memo["out"] = {k: torch.from_numpy(v) for k, v in lanes.to_arrays(got).items()}
        return {k: v.clone() for k, v in memo["out"].items()}

    drv.step = step
    drv.setup = lambda: None


def _u64_args(drv):
    saved = drv.blind
    drv.blind = drv.blind_used  # what the program was given
    try:
        return drv.ref_args(list(range(drv.B)))
    finally:
        drv.blind = saved


def _wnla_args(drv):
    from bench_port.harness.base import limbs_to_ints

    mu = limbs_to_ints(drv.mu.numpy())
    return [a + (mu[j],) for j, a in enumerate(drv.ref_args(list(range(drv.B))))]


STANDINS = {"u64.prove.b8192": ("u64_prove", _u64_args, 4),
            "wnla64.commit_prove.b8192": ("wnla_commit_prove", _wnla_args, 2)}


@pytest.mark.parametrize("kind", ["none", "control", "unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(STANDINS))
def test_prove_cells_see_each_fault(monkeypatch, cell, kind):
    job, args_of, B = STANDINS[cell]
    _small(monkeypatch, B)
    real = registry.driver(registry.workload(cell)["driver"]).Driver

    class StandIn(real):
        def make_inputs(self):
            super().make_inputs()
            _standin(self, job, args_of)

    monkeypatch.setattr(registry.driver(registry.workload(cell)["driver"]), "Driver", StandIn)
    out = _run(cell, fault=None if kind in ("none", "control") else kind, control=kind == "control")
    assert out["correct"] is (kind == "none"), out["checks"]
    assert out["checks"]["wrong_proofs"]["value"] == (0 if kind == "none" else out["failed"])


class _Ev:
    def __init__(self, name, start, end, device="DeviceType.CUDA"):
        self.name, self.device_type = name, device
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_a_trace_without_device_events_fails():
    from bench_port.harness import trace

    with pytest.raises(trace.NoDeviceEvents):
        trace.reduce_trace([_Ev("aten::mul", 0, 10, "DeviceType.CPU")], 1.0, 1, frozenset())
    with pytest.raises(trace.NoDeviceEvents):
        trace.reduce_trace([], 1.0, 1, frozenset())


def test_trace_reduction_on_known_events():
    from bench_port.harness import trace, readers

    ev = [_Ev("fixed_msm_kernel(int)", 0, 100), _Ev("void at::native::add<long>", 50, 300),
          _Ev("Memcpy DtoH", 400, 500), _Ev("aten::add", 0, 1000, "DeviceType.CPU")]
    t = trace.reduce_trace(ev, 0.001, 2, frozenset({"fixed_msm_kernel"}))
    assert t["busy_s"] == pytest.approx(400e-6)
    assert t["launches_per_batch"] == 1.0
    assert t["hand_written_s_per_batch"] == pytest.approx(50e-6)
    assert t["eager_s_per_batch"] == pytest.approx((250 + 100) * 1e-6 / 2)
    m = {"kind": "verify", "trace": t, "bound_s_per_batch": 5e-6}
    assert readers.device_idle_share(m, "verify") == pytest.approx(60.0)
    assert readers.hand_written_roofline(m, "verify") == pytest.approx(10.0)


def test_reference_stand_in_agrees_with_itself():
    a = refjobs.run("u64_prove", [("s", b"u64 range proof", 5, 7, list(range(1, 53)))], procs=1)
    b = refjobs.run("u64_prove", [("s", b"u64 range proof", 5, 7, list(range(1, 53)))], procs=1)
    assert a == b
    assert np.array_equal(lanes.to_arrays(a)["com"], lanes.to_arrays(b)["com"])
