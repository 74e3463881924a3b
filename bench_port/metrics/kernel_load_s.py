"""Seconds to build (a checkout's first run) or load the port's kernel
libraries (`ops/_build.build_all` and each library's load)."""


def read(m):
    return m.get("kernel_load_s")
