"""The single-card entry hook: the batched u64 fast-verify step.

Counterpart of `__graft_entry__.entry()` in the JAX package. `entry()`
returns the step a serving loop calls per batch and example arguments of
the shapes it takes; the step is the eager verifier (the JAX hook returns
its function un-jitted, for the caller to compile).
"""

from __future__ import annotations

LABEL = b"u64 range proof"
SEED = "graft entry"
CARD_BATCH = 1024  # on a CUDA device: the serving batch, with fixed-base tables
CPU_BATCH = 4  # on the CPU: a small batch without tables (the plain versions are slow)


def _u64_args(B: int, device="cuda"):
    """Zero-filled int64 verify inputs of the JAX hook's shapes
    (`__graft_entry__._u64_args`): (commitment bytes (33, B),
    ReciprocalProofBytes). Every lane is malformed, so a verifier rejects
    all of them."""
    import torch

    from .protocol.circuit import CircuitProofBytes
    from .protocol.reciprocal import ReciprocalProofBytes
    from .protocol.wnla import WNLAProofBytes

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    pb = ReciprocalProofBytes(
        circuit=CircuitProofBytes(
            c_l=z(33, B), c_r=z(33, B), c_o=z(33, B), c_s=z(33, B),
            wnla=WNLAProofBytes(r=z(33, 4, B), x=z(33, 4, B), l=z(16, 2, B), n=z(16, 1, B)),
        ),
        r=z(33, B),
    )
    return z(33, B), pb


def entry(device="cuda"):
    """-> (step, (dev, com_bytes, pb)). `step(dev, com_bytes, pb)` runs
    `U64RangeProofDevice.verify(..., fast=True)` under a fresh transcript
    and returns the (B,) accept mask. On a CUDA device B = CARD_BATCH with
    the fixed-base tables; on the CPU B = CPU_BATCH without them, as the
    JAX hook picks its batch by backend."""
    import torch

    from .models import u64_fixture
    from .transcript.device import Transcript

    B = CARD_BATCH if torch.device(device).type == "cuda" else CPU_BATCH
    _, dev, _ = u64_fixture(SEED, B, device=device, tables="auto")

    def step(dev, com_bytes, pb):
        batch = com_bytes.shape[1:]
        t = Transcript(LABEL, batch=tuple(batch), device=com_bytes.device)
        return dev.verify(com_bytes, t, pb, fast=True)

    return step, (dev, *_u64_args(B, device))
