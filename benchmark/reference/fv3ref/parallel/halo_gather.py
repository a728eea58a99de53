"""The reference's halo exchange across ranks, the plain way: every rank
gathers the whole cube's inputs of an exchange from all ranks and runs the
single-process exchange (``halo_slabs.py``) on them, keeping its own shards.

It shares nothing with the program's schedule between ranks (its frames,
rounds and re-based tables): the ghost cells of a rank's shards are copied
from the same whole-cube arrays, by the same region ops, as in a run in one
process, so the result equals that run's exactly. The cost is an
``all_gather`` of every input of every exchange, which the check can pay.
The region ops act level by level, so an input of several fields (the
tracer block) goes one field at a time: a card holds at most the ranks'
count times one 3-D field of each input beside the rank's own block.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.ranges import stage_range
from .halo_kernel import ExchangePlan, _compute_slab, _lift
from .halo_slabs import SlabHalo


def gather_cube(a: torch.Tensor, mesh) -> torch.Tensor:
    """The whole cube's ``(S, ...)`` array of which every rank holds its
    block ``a`` (``(k, ...)``, shards ``[rank * k, (rank + 1) * k)``)."""
    import torch.distributed as dist

    a = a.contiguous()
    whole = torch.empty((mesh.n_shards,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    dist.all_gather(list(whole.chunk(mesh.world_size)), a)
    return whole


def block_exchange(arrays: Dict[str, torch.Tensor], plan: ExchangePlan, lo: int,
                   hi: int) -> Dict[str, torch.Tensor]:
    """``halo_kernel.halo_plain`` on the whole cube's lifted ``(S, K, Y,
    X)`` inputs, its outputs kept for shards ``[lo, hi)`` alone."""
    ref = arrays[sorted(arrays)[0]]
    outs = {}
    for name, src, shape in plan.outputs:
        if src is not None:
            out = arrays[src][lo:hi].clone()
        else:
            out = torch.empty((hi - lo, ref.shape[1]) + tuple(shape), dtype=ref.dtype,
                              device=ref.device)
        for oname, op in plan.ops:
            if oname == name:
                r0, r1, c0, c1 = op.dst_rect
                out[..., r0:r1, c0:c1] = _compute_slab(op, arrays)[lo:hi]
        outs[name] = out
    return outs


class GatherHalo(SlabHalo):
    """:class:`~.halo_slabs.SlabHalo`'s methods on a rank's block of shards
    (fields ``(k, ..., Y, X)``), each exchange run on the gathered cube.
    The region ops are ``slabs``'s own."""

    def __init__(self, slabs: SlabHalo, mesh):
        super().__init__(slabs.halo)
        self._scalar_ops, self._vector_ops = slabs._scalar_ops, slabs._vector_ops
        self._sync_ops, self._plans = slabs._sync_ops, slabs._plans
        self.mesh = mesh

    def _exchange(self, inputs, plan: ExchangePlan):
        with stage_range("HaloExchange"):
            names = sorted(inputs)
            lead = tuple(inputs[names[0]].shape[:-2])
            lifted = {n: _lift(inputs[n]) for n in names}
            # one field's levels at a time (1 for a 2-D field)
            levels = lead[-1] if len(lead) > 1 else 1
            pieces = []
            for k0 in range(0, lifted[names[0]].shape[1], levels):
                whole = {n: gather_cube(a[:, k0:k0 + levels], self.mesh)
                         for n, a in lifted.items()}
                pieces.append(block_exchange(whole, plan, self.mesh.lo, self.mesh.hi))
                del whole
            return {name: torch.cat([p[name] for p in pieces], dim=1).reshape(
                lead + tuple(pieces[0][name].shape[-2:])) for name in pieces[0]}

    def _start(self, inputs, plan: ExchangePlan):
        return lambda: self._exchange(inputs, plan)
