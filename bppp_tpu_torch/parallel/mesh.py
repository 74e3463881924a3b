"""The mesh over a `torch.distributed` group: dp batch sharding and the tp
sharded MSM.

Counterpart of `bppp_tpu/parallel/mesh.py`. The JAX layer is SPMD inside
one process (`shard_map` over n devices, traced collectives); here each
rank is a process of an initialized process group and the collectives are
eager. The layouts are the JAX package's:

  * data parallel ("dp"): the proof batch is the LAST axis of every
    tensor and proofs are independent, so a rank keeps its contiguous
    share of the lanes and runs the single-card code on them, with zero
    collectives.
  * tensor parallel ("tp"): the points axis of an MSM is cut into
    contiguous blocks; each rank sums its block with `curve.msm`, one
    all_gather hands every rank's Jacobian partial to every rank, and a
    pairwise tree of complete adds sums them (a limbwise sum of Jacobian
    coordinates is not a point sum).

Every collective goes through `all_gather` or `all_reduce_sum` below, on a
contiguous tensor of the mesh's device. Gloo takes CUDA tensors (it stages
them through the host), which is how several ranks share one card; NCCL
refuses two ranks on one card, and its error is raised, not worked around.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import curve as dc
from ..ops.curve import PointJ


class Mesh(NamedTuple):
    """One named axis over the ranks of `group`; this process is `rank`
    of `size` and computes on `device`."""

    group: object
    axis: str
    rank: int
    size: int
    device: torch.device


def rank_device(device, rank: int) -> torch.device:
    """`device` with a card index: "cuda" without one means card
    LOCAL_RANK (torchrun's; else the global rank) modulo the cards this
    process sees, so ranks beyond the card count share cards."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        d = torch.device("cuda", local % torch.cuda.device_count())
    return d


def make_mesh(n: int | None = None, axis: str = "dp", device="cuda") -> Mesh | None:
    """A mesh over the first n ranks of the initialized process group
    (all of them when n is None). Making a subgroup is collective: every
    rank of the world calls this, and a rank outside the first n gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (multihost.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, axis, dist.get_rank(group), n, rank_device(device, rank))


def batch_slice(mesh: Mesh, B: int) -> slice:
    """This rank's contiguous lanes of a batch of B (counterpart of
    `batch_sharding`: the batch axis split evenly over the mesh)."""
    if B % mesh.size:
        raise ValueError(f"a batch of {B} lanes does not split over {mesh.size} ranks")
    per = B // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def map_tensors(tree, fn):
    """Apply `fn` to every tensor of a tree of NamedTuples, tuples, lists
    and dicts; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return tree


def shard_batch(tree, mesh: Mesh):
    """dp: every tensor of `tree` (batch-last layout) cut to this rank's
    lanes of its last axis, made contiguous, on the mesh's device. No
    collective."""
    return map_tensors(
        tree, lambda a: a[..., batch_slice(mesh, a.shape[-1])].contiguous().to(mesh.device)
    )


def all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's `t` (same shape on every rank), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise sum of every rank's `t`, in a tensor of its own
    (the reduction works in place, so never on a view of a shared one)."""
    s = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=mesh.group)
    return s


def combine_partials(local: PointJ, mesh: Mesh) -> PointJ:
    """Sum of every rank's Jacobian point (16, *batch), on every rank: one
    all_gather of the three stacked coordinates, then complete adds. The
    partials of two ranks are equal points wherever their blocks hold the
    same points and scalars, and the identity wherever a block's scalars
    are zero: `curve.pt_sum` (K7, incomplete adds) would lose such a lane."""
    parts = torch.stack(all_gather(torch.stack(tuple(local)), mesh), dim=2)  # (3, 16, n, *b)
    return dc._tree_sum_axis1(PointJ(*parts))


def msm_sharded(points: PointJ, scalars, mesh: Mesh) -> PointJ:
    """tp: sum_i [s_i] P_i with the points axis cut over the mesh.

    points coords and scalars are the GLOBAL (16, L, *batch) tensors,
    the same on every rank; L divisible by the mesh size. This rank runs
    `curve.msm` on its contiguous block of L / size points (moved to its
    device), and every rank returns the same point (16, *batch)."""
    L = points.x.shape[1]
    if L % mesh.size:
        raise ValueError(f"{L} points do not split over {mesh.size} ranks")
    per = L // mesh.size
    blk = slice(mesh.rank * per, (mesh.rank + 1) * per)
    local = dc.msm(
        PointJ(*(c[:, blk].to(mesh.device) for c in points)), scalars[:, blk].to(mesh.device)
    )
    return combine_partials(local, mesh)
