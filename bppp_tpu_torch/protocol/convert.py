"""Host <-> device bridges for protocol data, and the bridge between the
JAX package's arrays and this package's tensors.

Counterpart of `bppp_tpu/protocol/convert.py` (the part the verifier's
callers need). The host bridges lift oracle Points / python ints into
limb tensors; wire formats are SEC1 compressed points and 16-limb
scalars. `from_reference` / `to_reference` carry state across the two
packages: both use the same shapes and axis orders, so only the
container and the dtype change (uint32 numpy arrays there, int64 tensors
here). They take and return plain arrays and tuples, so nothing of the
JAX package is imported; its caller does the `np.asarray`. Fixed-base
tables are not carried across: their layout is the kernel's own, and
`ops/fixed_base.build_tables` rebuilds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curve as dc
from ..ops import field as f
from ..oracle import curve as oc


# -- scalars -------------------------------------------------------------


def scalar_cols(cols: list[list[int]]) -> np.ndarray:
    """cols[b] = per-lane scalar vector (len L) -> (16, L, B) limbs."""
    B = len(cols)
    L = len(cols[0])
    out = np.zeros((16, L, B), dtype=np.int64)
    for b, col in enumerate(cols):
        assert len(col) == L
        out[:, :, b] = f.ints_to_limbs(col)
    return out


# -- points --------------------------------------------------------------


def points_batched(pts: list[oc.Point], B: int, device="cuda") -> dc.PointJ:
    """Shared point vector, broadcast over a batch of B lanes:
    coords (16, L, B). Empty list -> zero-length identity vector."""
    if not pts:
        return dc.identity((0, B), device=device)
    return dc.from_int_points(pts, batch=(B,), device=device)


def point_batched(p: oc.Point, B: int, device="cuda") -> dc.PointJ:
    return dc.from_int_points([p], batch=(B,), squeeze=True, device=device)


def compressed_cols(pts_per_lane: list[list[oc.Point]]) -> np.ndarray:
    """pts_per_lane[b] = K points -> (33, K, B) SEC1 bytes."""
    B = len(pts_per_lane)
    K = len(pts_per_lane[0])
    out = np.zeros((33, K, B), dtype=np.int64)
    for b, pts in enumerate(pts_per_lane):
        for k, pt in enumerate(pts):
            out[:, k, b] = np.frombuffer(pt.to_bytes(), dtype=np.uint8)
    return out


def point_bytes(pts: list[oc.Point]) -> np.ndarray:
    """One point per lane -> (33, B) SEC1 bytes."""
    return np.stack(
        [np.frombuffer(p.to_bytes(), dtype=np.uint8).astype(np.int64) for p in pts],
        axis=1,
    )


# -- proofs ----------------------------------------------------------------


def reciprocal_proofs_to_bytes(proofs, device="cuda"):
    """One oracle ReciprocalProof per lane -> ReciprocalProofBytes on
    `device`."""
    from .circuit import CircuitProofBytes
    from .reciprocal import ReciprocalProofBytes
    from .wnla import WNLAProofBytes

    cps = [p.circuit_proof for p in proofs]
    up = lambda a: torch.from_numpy(a).to(device)
    return ReciprocalProofBytes(
        circuit=CircuitProofBytes(
            c_l=up(point_bytes([p.c_l for p in cps])),
            c_r=up(point_bytes([p.c_r for p in cps])),
            c_o=up(point_bytes([p.c_o for p in cps])),
            c_s=up(point_bytes([p.c_s for p in cps])),
            wnla=WNLAProofBytes(
                r=up(compressed_cols([p.r for p in cps])),
                x=up(compressed_cols([p.x for p in cps])),
                l=up(scalar_cols([p.l for p in cps])),
                n=up(scalar_cols([p.n for p in cps])),
            ),
        ),
        r=up(point_bytes([p.r for p in proofs])),
    )


# -- across the two packages --------------------------------------------------


def from_reference(obj, device="cuda"):
    """The JAX package's pytrees, given as numpy arrays, -> this package's
    containers on `device`: same shapes, int64 (masks stay bool). Accepts an array, a
    `PointJ`-shaped triple, a `WNLAProofBytes` / `CircuitProofBytes` /
    `ReciprocalProofBytes`-shaped namedtuple (matched by field names, so
    the JAX package's own classes and this package's both work), and
    tuples, lists and dicts of those."""
    from .circuit import CircuitProofBytes
    from .reciprocal import ReciprocalProofBytes
    from .wnla import WNLAProofBytes

    by_fields = {
        ("x", "y", "z"): dc.PointJ,
        ("r", "x", "l", "n"): WNLAProofBytes,
        ("c_l", "c_r", "c_o", "c_s", "wnla"): CircuitProofBytes,
        ("circuit", "r"): ReciprocalProofBytes,
    }
    if obj is None:
        return None
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        cls = by_fields.get(tuple(fields))
        if cls is None:
            raise TypeError(f"no counterpart for a container with fields {fields}")
        return cls(*(from_reference(v, device) for v in obj))
    if isinstance(obj, dict):
        return {k: from_reference(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(from_reference(v, device) for v in obj)
    arr = np.asarray(obj)
    if arr.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if arr.dtype.kind not in "ui":
        raise TypeError(f"expected an integer array, got dtype {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int64))).to(device)


def to_reference(obj):
    """The reverse of `from_reference`: this package's containers ->
    the same containers holding numpy uint32 arrays. Values must fit 32
    bits (limbs, bytes and masks do)."""
    if obj is None:
        return None
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_reference(v) for v in obj))
    if isinstance(obj, dict):
        return {k: to_reference(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_reference(v) for v in obj)
    a = f._np(obj)
    if a.dtype == np.bool_:
        return a
    if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
        raise ValueError("value does not fit the reference's uint32 arrays")
    return a.astype(np.uint32)
