"""Builds and loads the CUDA kernels of `bppp_tpu_torch/csrc/`.

Each `*.cu` source becomes one shared library with a plain C interface,
compiled by `nvcc` for sm_90a and loaded with `ctypes` — no PyTorch
headers, so a build takes seconds. The libraries are built at first use,
all sources in parallel (one `nvcc` process each), into
`bppp_tpu_torch/_build/<hash>/`, keyed on a hash of every file under
`csrc/` and of the flags. Nothing is built at import time: a machine
without `nvcc` can import every module and run the CPU paths.

A failed build raises `RuntimeError` with the compiler's output. There is
no fallback: a CUDA tensor launches its kernel or the call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_ROOT = os.path.join(os.path.dirname(_CSRC), "_build")

SOURCES = ("keccak", "pow", "curve", "fixed_msm", "msm_small", "msm_small_u4", "ladder")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of bppp_tpu_torch cannot be built on this machine"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_CSRC, name), "rb") as fh:
                h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no library yet (in parallel) and
    return {"seconds", "dir", "built": [...], "ptxas": {source: text}}."""
    if _INFO:
        return _INFO
    out_dir = os.path.join(_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    procs = []
    for name in SOURCES:
        so = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp,
               os.path.join(_CSRC, f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as fh:
            fh.write(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    ptxas = {}
    for name in SOURCES:
        log_path = os.path.join(out_dir, f"{name}.ptxas.txt")
        if os.path.exists(log_path):
            with open(log_path) as fh:
                ptxas[name] = fh.read()
    _INFO.update(
        seconds=time.time() - t0, dir=out_dir,
        built=[p[0] for p in procs], ptxas=ptxas,
    )
    return _INFO


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if need be."""
    if name not in _LIBS:
        info = build_all()
        _LIBS[name] = ctypes.CDLL(os.path.join(info["dir"], f"lib{name}.so"))
    return _LIBS[name]


VP = ctypes.c_void_p


def bind(lib_name: str, symbol: str, argtypes):
    """The C entry point `symbol` of `csrc/<lib_name>.cu`, with its
    argument types set (ctypes would otherwise pass each pointer as a
    32-bit int and cut it)."""
    fn = getattr(lib(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def resource_usage() -> dict:
    """{kernel symbol: {"registers", "spill_stores", "spill_loads",
    "stack"}} parsed from the `-Xptxas -v` output of the last build."""
    import re

    out = {}
    for text in build_all()["ptxas"].values():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = out.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out
