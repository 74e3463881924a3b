"""Device milliseconds per batch of the verify path in operations that are
not the port's hand-written kernels (eager PyTorch ops, copies)."""

from bench_port.harness.readers import eager_device_ms


def read(m):
    return eager_device_ms(m, "verify")
