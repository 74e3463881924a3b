"""Multi-process bootstrap.

Counterpart of `bppp_tpu/parallel/multihost.py`, which wraps
`jax.distributed.initialize` and builds one global mesh. Here a process
group of `torch.distributed` takes its place: one process per rank,
started by torchrun or by the caller, the dp axis over every rank of
every host. Proof batches are independent, so the data path needs no
collective; only the tp and sp paths (`mesh.msm_sharded`,
`wnla_shard.prove_sharded`) put traffic between ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, all_gather, make_mesh, map_tensors, rank_device


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> None:
    """Join the process group: `dist.init_process_group` with `backend`
    ("nccl" for a CUDA device, "gloo" for the CPU by default; pass "gloo"
    where several ranks share one card, which NCCL refuses), rendezvous at
    `tcp://{coordinator}` (a coordinator that names its scheme, such as
    `file:///path`, is used as given) for `num_processes` ranks, this one
    `process_id`; without a coordinator, torchrun's MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE. On a CUDA device the process's
    current card becomes its rank's (`mesh.rank_device`). A second call
    once a group exists does nothing, as `jax.distributed.initialize` on a
    host that knows its topology."""
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if coordinator is None:
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    world = -1 if num_processes is None else num_processes
    rank = -1 if process_id is None else process_id
    kw = {}
    if backend == "nccl" and rank >= 0:
        # bound to its card at once, so NCCL need not guess it from the rank
        kw["device_id"] = rank_device(device, rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    if kind == "cuda":
        torch.cuda.set_device(rank_device(device, dist.get_rank()))


def global_dp_mesh(axis: str = "dp", device="cuda") -> Mesh:
    """One dp axis over every rank of every host."""
    return make_mesh(None, axis=axis, device=device)


def shard_local_batch(tree, mesh: Mesh):
    """-> (tree on this rank's device, offset of its first lane in the
    global batch).

    Each process passes ITS OWN lanes (batch-last layout; every tensor of
    the tree has the same last axis). JAX's
    `make_array_from_process_local_data` returns one global array whose
    shards stay where they are; torch has no global array, so this returns
    the local tree itself, moved to the mesh's device and made contiguous,
    and where its lanes stand in the global batch: the sum of the lower
    ranks' batch sizes, from one all_gather of the sizes. The shares may
    differ in size."""
    sizes = {a.shape[-1] for a in _tensors(tree)}
    if len(sizes) != 1:
        raise ValueError(f"the tensors of a local batch differ in their last axis: {sorted(sizes)}")
    (b,) = sizes
    got = all_gather(torch.tensor([b], dtype=torch.int64, device=mesh.device), mesh)
    offset = sum(int(x) for x in got[: mesh.rank])
    return map_tensors(tree, lambda a: a.to(mesh.device).contiguous()), offset


def _tensors(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out
