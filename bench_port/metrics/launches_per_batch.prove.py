"""Device operations per batch of the prove path, by torch.profiler."""

from bench_port.harness.readers import launches_per_batch


def read(m):
    return launches_per_batch(m, "prove")
