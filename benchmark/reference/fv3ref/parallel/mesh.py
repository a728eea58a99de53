"""The reference's shard mesh: the stacked-shard axis split over the ranks of
the running torch.distributed process group.

It starts no process group of its own: it runs on the one the benchmark's
ranks started. Each rank owns the contiguous block of ``k = S / n`` shards
``[rank * k, (rank + 1) * k)``, every column whole, as the program's mesh
does:

    mesh = cube_mesh(n_shards, device)       # this rank's block of shards
    grid = grid.shard_block(mesh.lo, mesh.hi, mesh.n_shards)
    halo = GatherHalo(slabs, mesh)           # halo_gather.py

While a mesh is active (:func:`shard_mesh`), the operations whose result
reads the whole cube (the tracer sub-cycle count, the total-energy fixer's
sums) reduce over the ranks with :func:`all_reduce`; with no mesh it returns
its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CubeMesh:
    """This rank's place on the mesh: it owns shards ``[lo, hi)`` of
    ``n_shards``, its tensors on ``device`` (the process group's: a card
    under NCCL, the host under gloo)."""

    n_shards: int
    world_size: int
    rank: int
    device: torch.device

    @property
    def k(self) -> int:
        return self.n_shards // self.world_size

    @property
    def lo(self) -> int:
        return self.rank * self.k

    @property
    def hi(self) -> int:
        return self.lo + self.k


_ACTIVE: Optional[CubeMesh] = None


def get_shard_mesh() -> Optional[CubeMesh]:
    return _ACTIVE


@contextlib.contextmanager
def shard_mesh(mesh: Optional[CubeMesh]):
    """``mesh`` (or None) active for the reductions inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def cube_mesh(n_shards: int, device) -> CubeMesh:
    """This rank's block of ``n_shards`` over the running process group,
    its tensors on ``device``."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    if n_shards % n:
        raise ValueError(f"{n} ranks do not divide the {n_shards} shards")
    return CubeMesh(n_shards, n, r, torch.device(device))


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks of the active mesh (``"sum"`` or
    ``"max"``); ``t`` itself with no mesh active."""
    mesh = _ACTIVE
    if mesh is None:
        return t
    import torch.distributed as dist

    buf = t.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return buf
