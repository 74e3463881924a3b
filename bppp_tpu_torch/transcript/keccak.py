"""Batched Keccak-f[1600] behind the Merlin/STROBE transcript.

Counterpart of `bppp_tpu/transcript/keccak.py` (host twin:
`bppp_tpu_torch.oracle.keccak`). The sponge state is carried as a
(200, *batch) int64 BYTE tensor; packing to 25 lanes happens inside
`f1600_bytes`: one kernel launch on a CUDA tensor for any batch size, the
plain rounds of `ops/cuda_keccak.py` on a CPU tensor.
"""

from __future__ import annotations

from ..ops import cuda_keccak
from ..ops.cuda_keccak import f1600_lanes, pack_bytes, unpack_bytes

__all__ = ["f1600_bytes", "f1600_lanes", "pack_bytes", "unpack_bytes"]


def f1600_bytes(state):
    """(200, *batch) int64 byte state -> permuted byte state (through the
    module's wrapper, so that a run can note what each call is given)."""
    return cuda_keccak.f1600(state)
