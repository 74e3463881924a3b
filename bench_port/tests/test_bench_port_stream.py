"""The open loop times each proof from when it was due."""

import time
import types

import numpy as np
import torch

from bench_port.harness import registry


def _driver(rate, service_s):
    ctx = types.SimpleNamespace(workload=registry.workload("u64.verify_stream.p80"), seed=2**33 + 1,
                                device="cpu", control=False, label=b"x", seed_str="s")
    drv = registry.driver("verify_stream").Driver(ctx)
    sizes = []

    def fake_verify(start, size):
        sizes.append(size)
        time.sleep(service_s)
        return torch.ones(size, dtype=torch.bool)

    drv._verify = fake_verify
    drv.rate = rate
    return drv, sizes


def test_latency_counts_from_the_due_time():
    drv, sizes = _driver(rate=2000.0, service_s=0.05)
    win = drv.open_loop(drv.rate, 0.5)
    arr, lat, q = win["arrivals"], win["latency_ms"], win["queue_ms"]
    assert len(arr) == len(lat) > 0
    assert (lat >= q).all() and (q >= 0).all()
    # a batch's service time is in every latency; a proof that arrived while
    # the card was busy waited for it as well
    assert lat.min() >= 50.0 * 0.9
    assert lat.max() >= 50.0 + 0.9 * q.max()
    assert np.quantile(lat, 0.95) > 50.0
    assert all(s in drv.buckets for s in sizes)
    assert sum(k for k, _ in win["batches"]) == len(arr)


def test_a_stalled_card_delays_later_proofs():
    fast, _ = _driver(rate=500.0, service_s=0.01)
    slow, _ = _driver(rate=500.0, service_s=0.2)
    lf = fast.open_loop(500.0, 0.6)["latency_ms"]
    ls = slow.open_loop(500.0, 0.6)["latency_ms"]
    assert np.quantile(ls, 0.95) > np.quantile(lf, 0.95) + 150.0


def test_stream_arrivals_are_seeded():
    drv, _ = _driver(rate=1000.0, service_s=0.0)
    a = drv.open_loop(1000.0, 0.2)["arrivals"]
    b = drv.open_loop(1000.0, 0.2)["arrivals"]
    assert np.array_equal(a, b)
