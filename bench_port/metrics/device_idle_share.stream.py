"""The share of the traced window of the stream path in which no operation ran
on the card, in %."""

from bench_port.harness.readers import device_idle_share


def read(m):
    return device_idle_share(m, "stream")
