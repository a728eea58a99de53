"""The shard mesh: the stacked-shard axis split over ranks of torch.distributed.

Port of ``pace_tpu.parallel.mesh`` (reference role: the MPI world layout and
the ``mpirun -n N`` launch). ``pace_tpu`` shards the leading axis ``S =
6*ly*lx`` of one array program over a JAX mesh. Here each rank is its own
process and owns a contiguous block of ``k = S / n`` shards, every column
whole, as ``pace_tpu``'s devices do (``halo_shardmap.py``):

    initialize_distributed(device)           # torch.distributed, from the env
    mesh = cube_mesh(n_shards)               # this rank's block of shards
    state = shard_state(state, mesh)         # its block of every S-leading field
    grid = shard_state(grid, mesh)           # GridData.shard_block
    halo = DistributedHalo(slabs, mesh)      # halo_shardmap.py

``torchrun --nproc-per-node N python -m pace_tpu_torch.driver.run <yaml>``
runs a mesh config on N ranks. The backend follows from where the ranks
run: gloo on the CPU; NCCL when each rank has a card of its own; gloo with
the halo frames staged through host memory when ranks share a card.

While a mesh is active (:func:`set_shard_mesh`), the few operations whose
result reads the whole cube (the tracer sub-cycle count, the total-energy
fixer's sums, the safety checks) reduce over the ranks with
:func:`all_reduce`; with no mesh it returns its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Optional, Sequence, Tuple

import torch

from ..dtypes import resolve_device
from ..utils.logging import get_logger

logger = get_logger()


def layout_for(n_devices: int, n_tile: Optional[int] = None) -> Tuple[int, int]:
    """Smallest layout ``(ly, lx)`` whose shard count ``6*ly*lx`` divides
    evenly over ``n_devices``, square layouts first; with ``n_tile``, only
    layouts that divide the tile."""
    best: Optional[Tuple[int, int, int, int]] = None
    for ly in range(1, max(2, n_devices) + 1):
        for lx in range(1, max(2, n_devices) + 1):
            if (6 * ly * lx) % n_devices:
                continue
            if n_tile is not None and (n_tile % ly or n_tile % lx):
                continue
            cand = (6 * ly * lx, abs(ly - lx), ly, lx)
            if best is None or cand < best:
                best = cand
    if best is None:
        raise ValueError(
            f"no cube layout found for {n_devices} devices"
            + (f" with n_tile={n_tile}" if n_tile is not None else "")
        )
    return best[2], best[3]


@dataclasses.dataclass(frozen=True)
class CubeMesh:
    """This rank's place on the mesh: it owns shards ``[lo, hi)`` of
    ``n_shards``; ``host_staged``: collectives go through host buffers
    (gloo with ranks on one card)."""

    n_shards: int
    world_size: int
    rank: int
    backend: str
    device: torch.device
    host_staged: bool = False

    @property
    def k(self) -> int:
        return self.n_shards // self.world_size

    @property
    def lo(self) -> int:
        return self.rank * self.k

    @property
    def hi(self) -> int:
        return self.lo + self.k

    def to_comm(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it (on the host where staged)."""
        return t.cpu() if self.host_staged and t.device.type != "cpu" else t

    def from_comm(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if t.device != self.device else t


_ACTIVE: Optional[CubeMesh] = None


def set_shard_mesh(mesh: Optional[CubeMesh]) -> None:
    """Install ``mesh`` (or None) as the active mesh of the reductions."""
    global _ACTIVE
    _ACTIVE = mesh


def get_shard_mesh() -> Optional[CubeMesh]:
    return _ACTIVE


@contextlib.contextmanager
def shard_mesh(mesh: Optional[CubeMesh]):
    """Scoped form of :func:`set_shard_mesh`."""
    prev = _ACTIVE
    set_shard_mesh(mesh)
    try:
        yield mesh
    finally:
        set_shard_mesh(prev)


def _choose_backend(device: torch.device, local_world: int) -> Tuple[str, bool, torch.device]:
    """(backend, host_staged, this rank's device) from where the ranks run."""
    if device.type == "cpu":
        return "gloo", False, device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", False, torch.device("cuda", local_rank)
    return "gloo", True, torch.device("cuda", local_rank % max(cards, 1))


#: this process's rank device, as :func:`initialize_distributed` chose it
_RANK_DEVICE: Optional[torch.device] = None


def initialize_distributed(device="cuda", init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> Tuple[str, bool, torch.device]:
    """Start torch.distributed for this process, once, and return ``(backend,
    host_staged, device)``. The rendezvous comes from the arguments, else
    from the environment ``torchrun`` sets (``env://``), else a world of one
    rank through a file in a new temporary directory. The backend follows
    from the topology (see the module docstring) and is logged; NCCL that
    this PyTorch lacks raises rather than falling back. The device chosen
    is the one :func:`cube_mesh` takes by default: a card unless the caller
    passes ``device="cpu"``."""
    import torch.distributed as dist

    global _RANK_DEVICE
    device = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    backend, staged, dev = _choose_backend(device, local_world)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("each rank has a card of its own, so the mesh takes NCCL, and this "
                           "PyTorch has no NCCL")
    if dist.is_initialized():
        backend = dist.get_backend()
        staged = staged and backend == "gloo"
    else:
        if init_method is None:
            if "MASTER_ADDR" in os.environ:
                init_method = "env://"
            else:
                path = os.path.join(tempfile.mkdtemp(prefix="pace_mesh_"), "rendezvous")
                init_method = f"file://{path}"
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **kw)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    logger.info("mesh: rank %d of %d on %s, backend %s%s", dist.get_rank(),
                dist.get_world_size(), dev, backend,
                " (halo frames through host buffers: the ranks share a card)" if staged else "")
    return backend, staged, dev


def cube_mesh(n_shards: int, device=None, host_staged: Optional[bool] = None) -> CubeMesh:
    """This rank's block of ``n_shards`` over the running process group, on
    ``device``: by default the one :func:`initialize_distributed` chose,
    else the current card (the CPU only when the caller passes it). The
    frames go through host buffers when the backend is gloo and the device
    a card."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    if n_shards % n:
        raise ValueError(f"{n} ranks do not divide the {n_shards} shards")
    backend = dist.get_backend()
    if device is None:
        device = _RANK_DEVICE
    if device is None:
        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    device = resolve_device(device)
    if host_staged is None:
        host_staged = backend == "gloo" and device.type == "cuda"
    return CubeMesh(n_shards, n, r, backend, device, host_staged)


def _map_leaves(obj, fn, lead: int, names: Optional[Sequence[str]] = None):
    """``obj`` (a tensor, or a dataclass, dict, list or tuple of them,
    nested) with ``fn`` applied to every tensor. Every tensor of a state is
    shard-leading (``pace_tpu``'s ``shard_state`` maps every leaf too): one
    whose leading axis is not ``lead`` long raises. ``names``: only those
    fields of the outermost dataclass or dict, the others None (dataclass)
    or left out (dict)."""
    if isinstance(obj, torch.Tensor):
        if not obj.ndim or obj.shape[0] != lead:
            raise ValueError(f"a tensor of shape {tuple(obj.shape)} in a sharded state: its "
                             f"leading axis is not the {lead} shards")
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: (_map_leaves(getattr(obj, f.name), fn, lead)
                     if names is None or f.name in names else None)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn, lead) for k, v in obj.items()
                if names is None or k in names}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(v, fn, lead) for v in obj)
    return obj


def shard_state(obj, mesh: CubeMesh):
    """This rank's block of every tensor of ``obj`` (a state: a dataclass,
    nested, every tensor shard-leading; ``GridData`` through its
    ``shard_block``, which keeps its global fields and cuts the cube-corner
    table)."""
    if hasattr(obj, "shard_block"):
        return obj.shard_block(mesh.lo, mesh.hi, mesh.n_shards)
    return _map_leaves(obj, lambda t: t[mesh.lo:mesh.hi].contiguous(), mesh.n_shards)


def replicate(obj, mesh: CubeMesh):
    """Every tensor field of a dataclass on this rank's device: each rank
    holds the whole of it."""
    changes = {f.name: getattr(obj, f.name).to(mesh.device) for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **changes)


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks of the active mesh (``"sum"`` or
    ``"max"``); ``t`` itself with no mesh active."""
    mesh = _ACTIVE
    if mesh is None:
        return t
    import torch.distributed as dist

    buf = mesh.to_comm(t.clone())
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return buf.to(t.device)


def gather_to_root(t: torch.Tensor, mesh: CubeMesh) -> Optional[torch.Tensor]:
    """The whole ``(S, ...)`` field on rank 0 from each rank's block
    (``dist.gather``); None on the other ranks, which send their block."""
    import torch.distributed as dist

    if mesh.world_size == 1:
        return t
    src = mesh.to_comm(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)] if mesh.rank == 0 else None
    dist.gather(src, parts, dst=0)
    return torch.cat(parts).to(t.device) if mesh.rank == 0 else None


def gather_state(obj, mesh: CubeMesh, names: Optional[Sequence[str]] = None):
    """``obj`` (a state: a dataclass or dict, nested, every tensor of it
    this rank's block) whole on rank 0, for the driver's diagnostics and
    restarts, which rank 0 writes; None on the other ranks. ``names``: only
    those fields of ``obj`` (the others None, or left out of a dict). Every
    rank calls it with the same ``names``."""
    if mesh.world_size == 1:
        return obj
    whole = _map_leaves(obj, lambda t: gather_to_root(t, mesh), mesh.k, names)
    return whole if mesh.rank == 0 else None
