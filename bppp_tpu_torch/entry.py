"""The entry hooks: the batched u64 fast-verify step, and its dry run on
several ranks.

Counterpart of `__graft_entry__.py` in the JAX package. `entry()` returns
the step a serving loop calls per batch and example arguments of the
shapes it takes; the step is the eager verifier (the JAX hook returns its
function un-jitted, for the caller to compile). `dryrun_multichip(n)`
runs the step dp-sharded over n ranks and a tp-sharded MSM, as the JAX
hook does over n devices of one mesh.
"""

from __future__ import annotations

import time

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

    B = CARD_BATCH if torch.device(device).type == "cuda" else CPU_BATCH
    _, dev, _ = u64_fixture(SEED, B, device=device, tables="auto")
    return step, (dev, *_u64_args(B, device))


def step(dev, com_bytes, pb):
    """The fast-verify step: (B,) accept mask of the proofs `pb` of the
    commitments `com_bytes` under a fresh transcript."""
    from .transcript.device import Transcript

    batch = com_bytes.shape[1:]
    t = Transcript(LABEL, batch=tuple(batch), device=com_bytes.device)
    return dev.verify(com_bytes, t, pb, fast=True)


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> None:
    """The JAX hook's multi-device dry run on `n_devices` ranks of
    `torch.distributed`, spawned here with a file rendezvous in a
    temporary directory (parallel callers never collide on a port):

      * dp: `step` at B = 2 n on the zero arguments, every tensor cut to
        the rank's lanes by `shard_batch`: every rank's mask is all False;
      * tp: `msm_sharded` over the first L = 2 n points of
        [h_vec | g_vec] with scalars 3 + i over 2 lanes: the single-card
        `curve.msm`'s point on every rank.

    Rank 0 prints the JAX hook's `[dryrun +Xs] ...` marks. backend: as
    `multihost.initialize` ("nccl" on CUDA, "gloo" on the CPU by default);
    where the ranks outnumber the cards they share them, and the caller
    passes "gloo" (NCCL refuses two ranks on one card). On CUDA the
    kernels are built here first, so the ranks never race to build them.
    A rank that fails makes this raise."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from .models import u64_fixture

    t0 = time.time()
    if torch.device(device).type == "cuda":
        from .ops import _build

        _build.build_all()
    # the instances once, here, as CPU tensors; each rank moves its share
    _, dev, _ = u64_fixture("graft dryrun", 2 * n_devices, device="cpu", tables="never")
    _, small, _ = u64_fixture("graft msm", 2, device="cpu", tables="never")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(
            _dryrun_rank, nprocs=n_devices, join=True,
            args=(n_devices, f"file://{tmp}/rendezvous", device, backend, t0,
                  (dev.g, dev.g_vec, dev.h_vec), (small.h_vec, small.g_vec)),
        )


def _dryrun_rank(rank, n, rdzv, device, backend, t0, gens, tp_gens):
    import torch
    import torch.distributed as dist

    from .ops import curve as dc
    from .ops import field as f
    from .parallel import multihost
    from .parallel.mesh import make_mesh, msm_sharded, shard_batch
    from .protocol.u64 import U64RangeProofDevice, build_u64_tables

    def mark(label: str) -> None:
        if rank == 0:
            print(f"[dryrun +{time.time() - t0:7.1f}s] {label}", flush=True)

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(rdzv, n, rank, backend=backend, device=device)
    try:
        # -- dp: the batch cut across the ranks, zero collectives
        mesh = make_mesh(n, axis="dp", device=device)
        B = 2 * n
        g, g_vec, h_vec = shard_batch(gens, mesh)
        tables = None
        if mesh.device.type == "cuda":
            lane0 = lambda p: dc.PointJ(*(a[..., 0] for a in p))
            tables = build_u64_tables(lane0(g), lane0(g_vec), lane0(h_vec))
        dev = U64RangeProofDevice(g=g, g_vec=g_vec, h_vec=h_vec, tables=tables)
        com_bytes, pb = shard_batch(_u64_args(B, device="cpu"), mesh)
        mark("dp: fixture + sharded inputs ready")
        mask = step(dev, com_bytes, pb)
        mark("dp: step dispatched")
        if mask.cpu().any():
            raise RuntimeError(f"rank {rank}: the dp step accepted a zero proof")
        mark("dp: step executed")

        # -- tp: the points axis cut across the ranks, one all_gather
        tp = make_mesh(n, axis="tp", device=device)
        L = 2 * n
        pts = dc.PointJ(*(torch.cat([h, g_], dim=1)[:, :L] for h, g_ in zip(*tp_gens)))
        scalars = torch.from_numpy(f.ints_to_limbs([3 + i for i in range(L)]))[:, :, None]
        scalars = scalars.expand(pts.x.shape).contiguous()
        mark("tp: inputs ready")
        ref = dc.msm(dc.PointJ(*(a.to(tp.device) for a in pts)), scalars.to(tp.device))
        mark("tp: reference MSM done")
        got = msm_sharded(pts, scalars, tp)
        mark("tp: sharded MSM done")
        if not bool(dc.pt_eq(got, ref).all()):
            raise RuntimeError(f"rank {rank}: sharded MSM != single-device MSM")
        mark("tp: cross-check done")
    finally:
        dist.destroy_process_group()
