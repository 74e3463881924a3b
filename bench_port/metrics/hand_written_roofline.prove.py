"""The prove path's hand-written kernels against their roofline: the sum of
their launches' bounds (`metrics/_work.py`) over the sum of their device
time, per batch, in %."""

from bench_port.harness.readers import hand_written_roofline


def read(m):
    return hand_written_roofline(m, "prove")
