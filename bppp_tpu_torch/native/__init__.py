"""Wire bytes in, and the C++ host engine as a baseline.

Counterpart of `bppp_tpu/native/__init__.py`.

  * `pack_batch` turns N 525-byte u64 proof blobs (the wire layout of
    `native/bppp.cc`: C_L, C_R, C_O, C_S, R, X[4], R[4] as SEC1 points,
    then l[2] and n[1] as 32-byte big-endian scalars) into the verifier's
    `ReciprocalProofBytes` on a device: one host-to-device copy of the raw
    (N, 525) bytes, then the slicing, transposes and limb assembly run on
    that device.
  * `pack_oracle_proof` / `unpack_to_oracle` convert between a blob and
    the oracle's `ReciprocalProof`.
  * The ctypes bindings (`u64_prove`, `u64_verify`, `merlin_probe`,
    `fn_mul`, `fp_mul`, `fn_inv`, `pt_mul`) call the repo's C++ host engine
    `native/bppp.cc`, built at first use with `g++` into
    `bppp_tpu_torch/_build/` (never into `native/`, whose library belongs
    to the JAX package). It is a host baseline beside the port, not part of
    its path. A failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

PROOF_BYTES = 525
N_POINTS = 13  # C_L, C_R, C_O, C_S, R, X[4], R[4]
N_SCALARS = 3  # l[2], n[1]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "bppp.cc")
_BUILD = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def lib_path() -> str:
    """Where the host engine's library is built."""
    return os.path.join(_BUILD, "libbppp_host.so")


def load() -> ctypes.CDLL:
    """The host engine, built with g++ first if its library is missing or
    older than the source. Raises RuntimeError with g++'s output if the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = lib_path()
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"  # each concurrent build renames a whole file into place
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    u32, p = ctypes.c_uint32, ctypes.c_char_p
    sigs = {  # name: (argument types, result type), as `native/bppp.cc` declares them
        "bppp_u64_prove": ([p, u32, p, p, p, ctypes.c_uint64, p, p, p, p], ctypes.c_int),
        "bppp_u64_verify": ([p, u32, p, p, p, p, p], ctypes.c_int),
        "bppp_merlin_probe": ([p, u32, p, u32, p, u32, p, u32, p], None),
        "bppp_fn_mul": ([p, p, p], None),
        "bppp_fp_mul": ([p, p, p], None),
        "bppp_fn_inv": ([p, p], None),
        "bppp_pt_mul": ([p, p, p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def _pts_buf(points) -> bytes:
    return b"".join(p.to_bytes() for p in points)


def _public(public):
    return public.g.to_bytes(), _pts_buf(public.g_vec), _pts_buf(public.h_vec)


def u64_prove(public, x: int, s: int, label: bytes, blind: list[int]):
    """The engine's u64 prover. public: the oracle's U64RangeProof; blind:
    the 52 blinding draws in the reference's order. -> (proof blob (525
    bytes), commitment bytes (33))."""
    if len(blind) != 52:
        raise ValueError(f"the u64 prover takes 52 blinding draws, got {len(blind)}")
    out = ctypes.create_string_buffer(PROOF_BYTES)
    out_v = ctypes.create_string_buffer(33)
    blind_buf = b"".join(b.to_bytes(32, "big") for b in blind)
    rc = load().bppp_u64_prove(label, len(label), *_public(public), x,
                               s.to_bytes(32, "big"), blind_buf, out, out_v)
    if rc != 0:
        raise RuntimeError(f"native prove failed rc={rc}")
    return bytes(out.raw), bytes(out_v.raw)


def u64_verify(public, v_bytes: bytes, label: bytes, proof_bytes: bytes) -> bool:
    """The engine's u64 verifier on one blob."""
    if len(proof_bytes) != PROOF_BYTES or len(v_bytes) != 33:
        raise ValueError("a u64 proof is 525 bytes and its commitment 33")
    return load().bppp_u64_verify(label, len(label), *_public(public), v_bytes,
                                  proof_bytes) == 1


def merlin_probe(label: bytes, msg_label: bytes, msg: bytes, ch_label: bytes) -> bytes:
    """32 challenge bytes of a transcript that absorbed one message."""
    out = ctypes.create_string_buffer(32)
    load().bppp_merlin_probe(label, len(label), msg_label, len(msg_label), msg, len(msg),
                             ch_label, len(ch_label), out)
    return bytes(out.raw)


def _binop(name: str, a: int, b: int) -> int:
    out = ctypes.create_string_buffer(32)
    getattr(load(), name)(a.to_bytes(32, "big"), b.to_bytes(32, "big"), out)
    return int.from_bytes(out.raw, "big")


def fn_mul(a: int, b: int) -> int:
    return _binop("bppp_fn_mul", a, b)


def fp_mul(a: int, b: int) -> int:
    return _binop("bppp_fp_mul", a, b)


def fn_inv(a: int) -> int:
    out = ctypes.create_string_buffer(32)
    load().bppp_fn_inv(a.to_bytes(32, "big"), out)
    return int.from_bytes(out.raw, "big")


def pt_mul(p_bytes: bytes, k: int) -> bytes:
    out = ctypes.create_string_buffer(33)
    load().bppp_pt_mul(p_bytes, k.to_bytes(32, "big"), out)
    return bytes(out.raw)


# -- the 525-byte wire layout ------------------------------------------------


def pack_oracle_proof(proof) -> bytes:
    """oracle ReciprocalProof -> 525-byte wire blob."""
    cp = proof.circuit_proof
    out = b"".join(p.to_bytes() for p in (cp.c_l, cp.c_r, cp.c_o, cp.c_s, proof.r))
    out += b"".join(p.to_bytes() for p in cp.x)
    out += b"".join(p.to_bytes() for p in cp.r)
    out += b"".join(v.to_bytes(32, "big") for v in cp.l + cp.n)
    if len(out) != PROOF_BYTES:
        raise ValueError(f"not a u64 proof: {len(out)} bytes on the wire")
    return out


def unpack_to_oracle(blob: bytes):
    """525-byte wire blob -> oracle ReciprocalProof."""
    from ..oracle import curve
    from ..oracle.circuit import CircuitProof
    from ..oracle.reciprocal import ReciprocalProof

    if len(blob) != PROOF_BYTES:
        raise ValueError(f"a u64 proof blob is {PROOF_BYTES} bytes, got {len(blob)}")
    pts = [curve.from_bytes(blob[33 * i : 33 * (i + 1)]) for i in range(N_POINTS)]
    sc = blob[N_POINTS * 33 :]
    scalars = [int.from_bytes(sc[32 * i : 32 * (i + 1)], "big") for i in range(N_SCALARS)]
    return ReciprocalProof(
        circuit_proof=CircuitProof(
            c_l=pts[0], c_r=pts[1], c_o=pts[2], c_s=pts[3],
            x=pts[5:9], r=pts[9:13], l=scalars[:2], n=scalars[2:],
        ),
        r=pts[4],
    )


def pack_batch(blobs: list[bytes], device="cuda"):
    """N wire blobs -> the verifier's ReciprocalProofBytes of int64 tensors
    on `device`, in the JAX package's layout: batch last, the X / R points
    innermost-first as stored, scalars as 16 little-endian 16-bit limbs of
    their big-endian bytes. One host-to-device copy of the (N, 525) bytes;
    everything after it runs on `device`."""
    import torch

    from ..protocol.circuit import CircuitProofBytes
    from ..protocol.reciprocal import ReciprocalProofBytes
    from ..protocol.wnla import WNLAProofBytes

    B = len(blobs)
    if not B or any(len(b) != PROOF_BYTES for b in blobs):
        raise ValueError(f"pack_batch takes one or more blobs of {PROOF_BYTES} bytes")
    raw = torch.frombuffer(bytearray(b"".join(blobs)), dtype=torch.uint8).reshape(B, PROOF_BYTES)
    raw = raw.to(device).to(torch.int64)  # (B, 525)
    pts = raw[:, : N_POINTS * 33].reshape(B, N_POINTS, 33).permute(2, 1, 0)  # (33, 13, B)
    be = raw[:, N_POINTS * 33 :].reshape(B, N_SCALARS, 16, 2)  # big-endian byte pairs
    # limb i of a scalar is its bytes 30 - 2i (high) and 31 - 2i (low)
    limbs = ((be[..., 0] << 8) | be[..., 1]).flip(2).permute(2, 1, 0)  # (16, 3, B)

    def pt(i):
        return pts[:, i].contiguous()

    return ReciprocalProofBytes(
        circuit=CircuitProofBytes(
            c_l=pt(0), c_r=pt(1), c_o=pt(2), c_s=pt(3),
            wnla=WNLAProofBytes(
                r=pts[:, 9:13].contiguous(), x=pts[:, 5:9].contiguous(),
                l=limbs[:, :2].contiguous(), n=limbs[:, 2:].contiguous(),
            ),
        ),
        r=pt(4),
    )
