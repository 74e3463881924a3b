"""One run of one cell: set-up, the measured window or the traced
batches, the check against the reference, and the result line.

`run` is what `run.py` calls once it has found the cards; tests and
`control.py` call it too (on the CPU, with a fault planted, ...).
"""

from __future__ import annotations

import os
import resource
import sys
import time

from . import faults, program, registry, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "bppp_tpu")


class Context:
    """What a driver is given: the cell, its workload and configuration,
    the seed, the device, and what the run measured so far."""

    def __init__(self, cell: str, seed: int, device: str, bench: dict, control: bool = False):
        self.cell = cell
        self.bench = bench
        self.entry = registry.cell(bench, cell)
        self.workload = registry.workload(cell)
        self.config_name = self.entry["config"]
        self.config = registry.config(self.config_name)
        self.seed = int(seed)
        self.seed_str = traffic.seed_string(self.config_name, seed)
        self.device = device
        self.label = self.config["label"].encode()
        self.control = control


def few_threads() -> None:
    """One process with few threads: the port's host work is one thread of
    Python dispatch, and idle pool threads only take cores from it."""
    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _host_counters() -> dict:
    """What the host did for this process so far: CPU seconds, seconds it
    waited for a core (the kernel's run delay), the involuntary context
    switches, and the machine's steal ticks (time a hypervisor gave its
    cores to others). Read only; a counter that cannot be read is left out."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "involuntary_switches": ru.ru_nivcsw}
    try:
        with open("/proc/self/schedstat") as fh:
            out["run_delay_s"] = int(fh.read().split()[1]) / 1e9
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open("/proc/stat") as fh:
            cpu = fh.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def host_during(before: dict) -> dict:
    """The host counters' change since `before` (`_host_counters()`)."""
    now = _host_counters()
    return {k: now[k] - before[k] for k in now if k in before}


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def closed_loop(step, seconds: float) -> tuple:
    """Batches back to back until `seconds` have passed; each batch ends
    when the step returns (its answer on the host or synchronised).
    -> (outputs, each batch's end in seconds from the first one's start)."""
    outs, ends = [], []
    t0 = time.perf_counter()
    while True:
        outs.append(step())
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return outs, ends


def run(cell: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None, fault: str | None = None, control: bool = False,
        bench: dict | None = None) -> dict:
    """-> the result dict (the line `run.py` prints), or raises."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.benchmark() if bench is None else bench
    ctx = Context(cell, seed, device, bench, control=control)
    drv = registry.driver(ctx.workload["driver"]).Driver(ctx)
    if device.startswith("cuda"):
        torch.zeros(1, device=device)  # CUDA context: part of set-up

    t0 = time.perf_counter()
    drv.make_inputs()
    _sync(device)
    inputs_s = time.perf_counter() - t0

    meas = {"kind": drv.kind}
    meas["kernel_load_s"] = program.load_kernels() if device.startswith("cuda") else None
    t0 = time.perf_counter()
    drv.setup()
    _sync(device)
    meas["fixture_s"] = time.perf_counter() - t0

    step = drv.step
    if fault is not None:
        bad = faults.FAULTS[fault]
        step = lambda: bad(drv.step())  # noqa: E731
    if hasattr(drv, "warm"):
        drv.warm()
    else:
        for _ in range(drv.warm_batches):
            step()
    _sync(device)
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    program.reset_counts()
    setup_s = time.perf_counter() - t_start - inputs_s

    breakdown = None
    if traced:
        hand = program.hand_written_names()
        log_ = []
        with program.launch_log(log_):
            prof = trace.profile_batches(step, drv.trace_batches, hand)
        outs, window = prof.pop("outs"), None
        meas["trace"] = prof
        meas["bound_s_per_batch"] = sum(trace_bound(log_)) / prof["batches"]
        gaps = trace.idle_gaps(getattr(drv, "one_batch", step)) if device.startswith("cuda") else []
        breakdown = {"device_ops": trace.top_ops(prof["by_name"]), "idle_gaps": gaps}
        hand_ops = trace.top_ops({k: v / prof["batches"] for k, v in prof["hand_by_name"].items()}, 16)
    else:
        host0 = _host_counters()
        t_window = time.perf_counter()
        window = drv.window(step, seconds)
        host = dict(host_during(host0), wall_s=time.perf_counter() - t_window)
        outs = window["outs"]
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    launches, plain = program.read_counts()

    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"modules of the JAX side are loaded: {bad_mods}")

    checks, attempted, failed = drv.check(outs, window)
    if device.startswith("cuda"):
        checks.append(("plain_calls", sum(plain.values()), 0))
    correct = all(v <= lim for _, v, lim in checks)

    metrics = {}
    if traced:
        for m in registry.per_layer_of(bench, cell):
            v = registry.metric(m["name"]).read(meas)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(window), setup_s=setup_s)
        for m in registry.end_to_end_of(bench, cell):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = meas["trace"]["busy_s"]
        dev["window_s"] = meas["trace"]["window_s"]
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["inputs_s"] = inputs_s
    out["launches"] = {k: v for k, v in launches.items() if v}
    if traced:
        out["hand_written_s_per_batch"] = hand_ops
    out.update(drv.extra(window))
    if window is not None:
        out["host"] = host
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def trace_bound(log_: list) -> list:
    work = registry.metric("_work")
    return [work.bound_s(ops, nbytes) for _, ops, nbytes in log_]
