"""Ranks, meshes and collectives (port of chromegcn_tpu/parallel/mesh.py).

The reference runs SPMD over a named device mesh, and XLA's GSPMD inserts
every collective: under ``jit`` over sharded arrays, BatchNorm sees the
global batch, the masked loss is the global mean and the replicated
parameters get the whole gradient without a line of code. Here each rank is
one process of ``torch.distributed`` and each of those collectives is
written out, as a small ``torch.autograd.Function`` where it needs a
gradient:

- ``all_reduce_sum``: sum over the group; its backward sums the partial
  cotangents of every rank (BatchNorm's statistics, which each rank's own
  rows read);
- ``reduce_replicated``: sum over the group; its backward is the identity,
  for an output whose cotangent every rank holds whole (the loss, which
  every rank computes alike and differentiates from 1; a row-parallel
  product's output);
- ``copy_to_group``: the identity; its backward sums over the group (the
  replicated input of a tensor-parallel layer);
- ``all_gather_rows``: every rank's rows, concatenated; its backward sums
  the cotangents and keeps this rank's rows (a sharded graph's
  ``all_gather`` strategy, ChromeRNN's sequence).

After backward each replicated parameter holds this rank's part of one
global mean's gradient, so ``all_reduce_grads`` sums them: averaging, as
DistributedDataParallel does, would be wrong by the rank count.

The backend follows the device: gloo for CPU tensors, NCCL for CUDA ones.
Nothing swaps one for the other.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from chromegcn_tpu_torch import DeviceLike, resolve_device
from chromegcn_tpu_torch.parallel.multihost import put_global


def backend_for(device: torch.device) -> str:
    """The process-group backend that carries tensors on ``device``."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(
    device: DeviceLike = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[timedelta] = None,
) -> bool:
    """Join the process group this process was launched into; returns
    whether there is one.

    Reads the explicit arguments or torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). Does nothing
    in a process launched alone. For NCCL it selects the card
    ``LOCAL_RANK`` names before creating the group, as the reference
    brings up its distributed runtime before touching a device (its
    ordering contract, parallel/mesh.py:35-41). A group that exists already
    must have the backend ``device`` needs."""
    device = resolve_device(device)
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, and {device.type} tensors "
                f"need {backend}")
        return True
    explicit = any(a is not None for a in (init_method, world_size, rank))
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and env_world <= 1:
        return False
    if world_size is None:
        world_size = env_world
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a grid of ranks with named axes, the last axis
    minor (rank = row-major index). ``groups[axis]`` is the process group of
    the ranks that differ from this one only along ``axis``; None where the
    axis has size 1 (nothing to exchange)."""

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        i = self.axes.index(axis)
        minor = 1
        for n in self.shape[i + 1:]:
            minor *= n
        return (self.rank // minor) % self.shape[i]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def _world(needed: int, what: str) -> Tuple[int, int]:
    """(rank, world) of this process, which must be one of ``needed`` ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != needed:
        raise ValueError(
            f"{what} needs {needed} ranks, and this process is one of {world}: launch "
            f"{needed} processes (torchrun --nproc_per_node {needed} -m "
            f"chromegcn_tpu_torch.main ...)")
    return (dist.get_rank() if dist.is_initialized() else 0), world


def make_mesh(n: int, axis: str = "data") -> Mesh:
    """A 1-D mesh of ``n`` ranks; this process must be one of exactly ``n``
    (the reference raises the same way when the mesh lacks devices,
    parallel/mesh.py:82-93)."""
    rank, _ = _world(n, f"mesh axis {axis!r}")
    return Mesh((axis,), (n,), rank, {axis: dist.group.WORLD if n > 1 else None})


def make_mesh_2d(outer: int, inner: int, axes: Sequence[str] = ("data", "graph")) -> Mesh:
    """An ``outer`` x ``inner`` mesh: batch-axis data parallelism on the
    outer axis, the graph (or model) axis minor, as in the reference. Every
    rank creates every row and column group, in the same order, as
    ``dist.new_group`` requires."""
    axes = tuple(axes)
    rank, _ = _world(outer * inner, f"mesh {outer}x{inner}")
    groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in axes}
    if outer > 1:
        for m in range(inner):  # columns: one rank of each row
            members = [d * inner + m for d in range(outer)]
            g = dist.new_group(members)
            if rank in members:
                groups[axes[0]] = g
    if inner > 1:
        for d in range(outer):  # rows
            members = [d * inner + m for m in range(inner)]
            g = dist.new_group(members)
            if rank in members:
                groups[axes[1]] = g
    return Mesh(axes, (outer, inner), rank, groups)


def shard_batch(mesh: Mesh, axis: str = "data"):
    """Placement of host batches: this rank's rows of each."""
    return lambda arr: put_global(arr, mesh.index(axis), mesh.size(axis))


def node_sharding(mesh: Mesh, axis: str = "graph"):
    """Placement of (N, d) chromosome arrays: this rank's contiguous rows."""
    return shard_batch(mesh, axis)


def group_rank(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(this process's rank in ``group``, its size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Collectives under autograd
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in rank order (no
    gradient)."""
    _, world = group_rank(group)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        rank, _ = group_rank(ctx.group)
        return _all_reduce(g, ctx.group)[rank * ctx.n:(rank + 1) * ctx.n], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward sums every rank's cotangent. ``x``
    itself for no group."""
    return x if group is None else _AllReduceSum.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward passes the (replicated) cotangent
    through. ``x`` itself for no group."""
    return x if group is None else _ReduceReplicated.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the cotangent over ``group``."""
    return _CopyToGroup.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order; the backward
    hands each rank its rows of the summed cotangents."""
    return _AllGatherRows.apply(x, group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum every gradient over ``group``, in one flat all-reduce per dtype:
    each rank holds its part of one global mean's gradient."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
