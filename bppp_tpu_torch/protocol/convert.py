"""Host <-> device bridges for protocol data, and the bridge between the
JAX package's arrays and this package's tensors.

Counterpart of `bppp_tpu/protocol/convert.py`. The host bridges lift
oracle Points / python ints into limb tensors and lower results back into
oracle objects for cross-checks and serialization; wire formats are SEC1
compressed points and 16-limb scalars. The `*_dev_to_bytes` bridges turn
a proof the prover made into the verifier's wire form without leaving
the device. `from_reference` / `to_reference` carry state across the two
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


def scalars_lane(arr, b) -> list[int]:
    """(16, L, B) limbs -> python ints of lane b."""
    return f.limbs_to_ints(f._np(arr)[:, :, b])


def scalar_lane(arr, b) -> int:
    """(16, B) limbs -> the python int of lane b."""
    return f.limbs_to_ints(f._np(arr)[:, b : b + 1])[0]


# -- points --------------------------------------------------------------


def points_batched(pts: list[oc.Point], B: int, device="cuda") -> dc.PointJ:
    """Shared point vector, broadcast over a batch of B lanes:
    coords (16, L, B). Empty list -> zero-length identity vector."""
    if not pts:
        return dc.identity((0, B), device=device)
    return dc.from_int_points(pts, batch=(B,), device=device)


def point_batched(p: oc.Point, B: int, device="cuda") -> dc.PointJ:
    return dc.from_int_points([p], batch=(B,), squeeze=True, device=device)


def point_lane(p: dc.PointJ, b) -> oc.Point:
    """PointJ coords (16, B) -> oracle Point at lane b."""
    return oc.Point(*(scalar_lane(a, b) for a in p))


def point_vec_lane(p: dc.PointJ, b) -> list[oc.Point]:
    """PointJ coords (16, L, B) -> oracle Points at lane b."""
    xs, ys, zs = (scalars_lane(a, b) for a in p)
    return [oc.Point(x, y, z) for x, y, z in zip(xs, ys, zs)]


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


def wnla_proofs_to_bytes(proofs, device="cuda"):
    """One oracle WNLAProof (or CircuitProof: same four fields) per lane
    -> WNLAProofBytes on `device`. All lanes share sizes."""
    from .wnla import WNLAProofBytes

    up = lambda a: torch.from_numpy(a).to(device)
    return WNLAProofBytes(
        r=up(compressed_cols([p.r for p in proofs])),
        x=up(compressed_cols([p.x for p in proofs])),
        l=up(scalar_cols([p.l for p in proofs])),
        n=up(scalar_cols([p.n for p in proofs])),
    )


def wnla_dev_to_oracle(proof, b):
    from ..oracle.wnla import WNLAProof

    return WNLAProof(
        r=point_vec_lane(proof.r, b),
        x=point_vec_lane(proof.x, b),
        l=scalars_lane(proof.l, b),
        n=scalars_lane(proof.n, b),
    )


def wnla_dev_to_bytes(proof):
    """WNLAProofDev (Jacobian points) -> WNLAProofBytes, compressing on
    the proof's device."""
    from .wnla import WNLAProofBytes

    return WNLAProofBytes(
        r=dc.compress(proof.r), x=dc.compress(proof.x), l=proof.l, n=proof.n
    )


def circuit_proofs_to_bytes(proofs, device="cuda"):
    """One oracle CircuitProof per lane -> CircuitProofBytes on `device`."""
    from .circuit import CircuitProofBytes

    up = lambda a: torch.from_numpy(a).to(device)
    return CircuitProofBytes(
        c_l=up(point_bytes([p.c_l for p in proofs])),
        c_r=up(point_bytes([p.c_r for p in proofs])),
        c_o=up(point_bytes([p.c_o for p in proofs])),
        c_s=up(point_bytes([p.c_s for p in proofs])),
        wnla=wnla_proofs_to_bytes(proofs, device=device),
    )


def reciprocal_proofs_to_bytes(proofs, device="cuda"):
    """One oracle ReciprocalProof per lane -> ReciprocalProofBytes on
    `device`."""
    from .reciprocal import ReciprocalProofBytes

    return ReciprocalProofBytes(
        circuit=circuit_proofs_to_bytes([p.circuit_proof for p in proofs], device=device),
        r=torch.from_numpy(point_bytes([p.r for p in proofs])).to(device),
    )


def circuit_dev_to_oracle(proof, b):
    """CircuitProofDev -> oracle CircuitProof at lane b."""
    from ..oracle.circuit import CircuitProof

    return CircuitProof(
        c_l=point_lane(proof.c_l, b),
        c_r=point_lane(proof.c_r, b),
        c_o=point_lane(proof.c_o, b),
        c_s=point_lane(proof.c_s, b),
        r=point_vec_lane(proof.wnla.r, b),
        x=point_vec_lane(proof.wnla.x, b),
        l=scalars_lane(proof.wnla.l, b),
        n=scalars_lane(proof.wnla.n, b),
    )


def reciprocal_dev_to_oracle(proof, b):
    """ReciprocalProofDev -> oracle ReciprocalProof at lane b."""
    from ..oracle.reciprocal import ReciprocalProof

    return ReciprocalProof(
        circuit_proof=circuit_dev_to_oracle(proof.circuit, b),
        r=point_lane(proof.r, b),
    )


def _circuit_dev_to_bytes(cp, *more):
    """CircuitProofDev (and `more` single points) -> (CircuitProofBytes,
    [bytes of each of `more`]): the circuit's four points and `more`
    compress in one stacked call, the WNLA X / R in another, so a proof goes
    from the prover to the verifier without a host round trip."""
    from .circuit import CircuitProofBytes

    singles = (cp.c_l, cp.c_r, cp.c_o, cp.c_s) + more
    byts = dc.compress(dc.PointJ(*(torch.stack(cs, dim=1) for cs in zip(*singles))))
    return CircuitProofBytes(
        c_l=byts[:, 0], c_r=byts[:, 1], c_o=byts[:, 2], c_s=byts[:, 3],
        wnla=wnla_dev_to_bytes(cp.wnla),
    ), [byts[:, 4 + i] for i in range(len(more))]


def circuit_dev_to_bytes(proof):
    """CircuitProofDev -> CircuitProofBytes on the proof's device."""
    return _circuit_dev_to_bytes(proof)[0]


def reciprocal_dev_to_bytes(proof):
    """ReciprocalProofDev -> ReciprocalProofBytes on the proof's device (the
    poles commitment compresses with the circuit's four points)."""
    from .reciprocal import ReciprocalProofBytes

    circuit, (r,) = _circuit_dev_to_bytes(proof.circuit, proof.r)
    return ReciprocalProofBytes(circuit=circuit, r=r)


# -- instance lifting ------------------------------------------------------


def matrix_const(rows: list[list[int]], B: int, device="cuda"):
    """Host int matrix -> (16, R, C, B) limbs on `device`, broadcast over
    the B lanes (an `expand` view)."""
    R, C = len(rows), len(rows[0])
    limbs = f.ints_to_limbs([v for row in rows for v in row]).reshape(16, R, C, 1)
    return torch.from_numpy(limbs).to(device).expand(16, R, C, B)


def vector_const(vals: list[int], B: int, device="cuda"):
    """Host int vector -> (16, L, B) limbs on `device`, broadcast over the
    B lanes (an `expand` view)."""
    limbs = f.ints_to_limbs(list(vals)).reshape(16, len(vals), 1)
    return torch.from_numpy(limbs).to(device).expand(16, len(vals), B)


def circuit_from_oracle(circ, B: int, device="cuda", tables=None):
    """Lift an oracle ArithmeticCircuit instance (static W / a data) into an
    ArithmeticCircuitDevice over a B-lane batch on `device`. `tables`: the
    fixed-base window tables over its generators, {'full': [g | h_vec +
    h_vec_ | g_vec + g_vec_], 'gv': [g | g_vec]}, or None."""
    from .circuit import ArithmeticCircuitDevice

    return ArithmeticCircuitDevice(
        dim_nm=circ.dim_nm,
        dim_no=circ.dim_no,
        k=circ.k,
        dim_nl=circ.dim_nl,
        dim_nv=circ.dim_nv,
        dim_nw=circ.dim_nw,
        g=point_batched(circ.g, B, device=device),
        g_vec=points_batched(circ.g_vec, B, device=device),
        h_vec=points_batched(circ.h_vec, B, device=device),
        W_m=matrix_const(circ.W_m, B, device=device),
        W_l=matrix_const(circ.W_l, B, device=device),
        a_m=vector_const(circ.a_m, B, device=device),
        a_l=vector_const(circ.a_l, B, device=device),
        f_l=circ.f_l,
        f_m=circ.f_m,
        g_vec_=points_batched(circ.g_vec_, B, device=device),
        h_vec_=points_batched(circ.h_vec_, B, device=device),
        partition=circ.partition,
        tables=tables,
    )


# -- across the two packages --------------------------------------------------


def from_reference(obj, device="cuda"):
    """The JAX package's pytrees, given as numpy arrays, -> this package's
    containers on `device`: same shapes, int64 (masks stay bool). Accepts
    an array, a `PointJ`-shaped triple, a proof or witness namedtuple of
    either package (`WNLAProofBytes` / `WNLAProofDev`, `CircuitProofBytes`
    / `CircuitProofDev`, `ReciprocalProofBytes` / `ReciprocalProofDev`,
    `CircuitWitnessDev`, `ReciprocalWitnessDev` — matched by field names;
    the wire and the device form of a proof share theirs and are told
    apart by whether their points are byte arrays or `PointJ` triples),
    and tuples, lists and dicts of those."""
    from .circuit import CircuitProofBytes, CircuitProofDev, CircuitWitnessDev
    from .reciprocal import ReciprocalProofBytes, ReciprocalProofDev, ReciprocalWitnessDev
    from .wnla import WNLAProofBytes, WNLAProofDev

    by_fields = {
        ("x", "y", "z"): (dc.PointJ, dc.PointJ),
        ("r", "x", "l", "n"): (WNLAProofBytes, WNLAProofDev),
        ("c_l", "c_r", "c_o", "c_s", "wnla"): (CircuitProofBytes, CircuitProofDev),
        ("circuit", "r"): (ReciprocalProofBytes, ReciprocalProofDev),
        ("v", "s_v", "w_l", "w_r", "w_o"): (CircuitWitnessDev, CircuitWitnessDev),
        ("x", "s", "m", "digits"): (ReciprocalWitnessDev, ReciprocalWitnessDev),
    }
    if obj is None:
        return None
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        pair = by_fields.get(tuple(fields))
        if pair is None:
            raise TypeError(f"no counterpart for a container with fields {fields}")
        # a proof as the prover leaves it holds points (triples with fields
        # x, y, z) where its wire form holds byte arrays
        is_dev = any(getattr(v, "_fields", None) == ("x", "y", "z") for v in obj)
        return pair[is_dev](*(from_reference(v, device) for v in obj))
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
