"""Wire lanes (`reference.wire`) <-> arrays with the batch on the last
axis, as the port's wire tensors lie: points (33, [K,] B) bytes, scalars
(16, L, B) 16-bit limbs, all int64."""

from __future__ import annotations

import numpy as np

POINT_KEYS = ("com", "c_l", "c_r", "c_o", "c_s", "r")
VEC_POINT_KEYS = ("wnla_r", "wnla_x")
SCALAR_KEYS = ("wnla_l", "wnla_n")


def to_arrays(lanes: list) -> dict:
    out = {}
    keys = lanes[0].keys()
    for k in keys:
        if k in POINT_KEYS:
            out[k] = np.stack([np.frombuffer(ln[k], dtype=np.uint8) for ln in lanes], axis=-1)
        elif k in VEC_POINT_KEYS:
            out[k] = np.stack([np.stack([np.frombuffer(b, dtype=np.uint8) for b in ln[k]], axis=-1)
                               for ln in lanes], axis=-1)
        elif k in SCALAR_KEYS:
            out[k] = np.stack([np.array(ln[k], dtype=np.int64).T for ln in lanes], axis=-1)
        else:
            raise KeyError(k)
        out[k] = out[k].astype(np.int64)
    return out


def lane_at(arrs: dict, b: int) -> dict:
    lane = {}
    for k, a in arrs.items():
        a = np.asarray(a)
        if k in POINT_KEYS:
            lane[k] = bytes(a[:, b].astype(np.uint8).tolist())
        elif k in VEC_POINT_KEYS:
            lane[k] = [bytes(a[:, i, b].astype(np.uint8).tolist()) for i in range(a.shape[1])]
        elif k in SCALAR_KEYS:
            lane[k] = [tuple(int(v) for v in a[:, i, b]) for i in range(a.shape[1])]
    return lane


def tile(arrs: dict, B: int) -> dict:
    """Lane b of the result holds lane b % n of `arrs`."""
    out = {}
    for k, a in arrs.items():
        reps = -(-B // a.shape[-1])
        out[k] = np.ascontiguousarray(np.tile(a, (1,) * (a.ndim - 1) + (reps,))[..., :B])
    return out
