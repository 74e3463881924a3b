"""The single-card entry hook of the port against the JAX package's
`__graft_entry__.entry()`: the same argument shapes, and the step on the
zero-filled arguments rejects every lane. `slow`: the same mask as the JAX
hook's step (a cold XLA compile of the whole fast verifier)."""

import os
import sys

import numpy as np
import pytest

from bppp_tpu_torch.entry import CPU_BATCH, entry

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def hook():
    return entry(device="cpu")


def _shapes(obj):
    if hasattr(obj, "shape"):
        return tuple(obj.shape)
    return tuple(_shapes(v) for v in obj)


def test_entry_on_the_cpu_takes_the_jax_hooks_shapes_and_rejects_zero_proofs(hook):
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    step, (dev, com_bytes, pb) = hook
    want_com, want_pb = graft._u64_args(CPU_BATCH)
    assert _shapes((com_bytes, pb)) == _shapes((want_com, want_pb))
    assert all(str(a.device) == "cpu" and str(a.dtype) == "torch.int64"
               for a in (com_bytes, pb.r, pb.circuit.wnla.l))
    assert dev.batch == (CPU_BATCH,) and dev.tables is None
    mask = step(dev, com_bytes, pb)
    assert tuple(mask.shape) == (CPU_BATCH,) and mask.dtype.is_floating_point is False
    assert mask.tolist() == [False] * CPU_BATCH


@pytest.mark.slow
def test_entry_mask_equals_the_jax_hooks(hook):
    """The JAX hook's step, compiled through its `aot` cache, on its own
    arguments and on the port's (carried across as numpy): the port's mask.
    Slow: XLA compiles the whole fast verifier for the CPU."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft
    from bppp_tpu.protocol.circuit import CircuitProofBytes
    from bppp_tpu.protocol.reciprocal import ReciprocalProofBytes
    from bppp_tpu.protocol.wnla import WNLAProofBytes
    from bppp_tpu.utils import aot

    from bppp_tpu_torch.protocol import convert as cv

    step, args = hook
    jstep, jargs = graft.entry()
    prog = aot.cached(f"test_torch_entry_step_b{CPU_BATCH}", jstep)
    ours = step(*args)
    assert ours.tolist() == np.asarray(prog(*jargs)).tolist()
    _, com_bytes, pb = args
    r = cv.to_reference(pb)
    jpb = ReciprocalProofBytes(
        circuit=CircuitProofBytes(*r.circuit[:4], WNLAProofBytes(*r.circuit.wnla)), r=r.r)
    assert np.asarray(prog(jargs[0], cv.to_reference(com_bytes), jpb)).tolist() == ours.tolist()
