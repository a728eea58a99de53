"""Application of halo-exchange region ops, in plain PyTorch.

An :class:`ExchangePlan` names the outputs of one exchange — each a copy of
one input with its ghost regions rewritten, or a region-only output such as
the y-fold corner pack — and the region ops that write them. Inputs and
outputs are ``(S, ..., Y, X)``; the middle axes are flattened into one level
axis K (a 3-D field has K = 1).

:func:`exchange` applies the ops as strip updates (``pace_tpu``'s
``_assemble_dus``) and returns new tensors; the inputs are never written.
An exchange writes ``n_out`` shards (all of the inputs' by default).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(eq=False)
class ExchangePlan:
    """``outputs``: ``(name, source input name, None)`` for a copy-through
    output, ``(name, None, (y, x))`` for a region-only output whose every
    point is written by its ops. ``ops``: ``(output name, region op)`` in
    application order; an op's classes name input components as sources."""

    outputs: Tuple
    ops: Tuple


def _lift(a: torch.Tensor) -> torch.Tensor:
    return a.reshape((a.shape[0], -1) + tuple(a.shape[-2:]))


def exchange(inputs: Dict[str, torch.Tensor], plan: ExchangePlan,
             n_out=None) -> Dict[str, torch.Tensor]:
    """Run one exchange; returns ``{output name: tensor}``, each shaped like
    its source input (region-only outputs follow the first input's leading
    axes), over the first ``n_out`` shards."""
    names = sorted(inputs)
    first = inputs[names[0]]
    for n in names[1:]:
        a = inputs[n]
        if a.shape[0] != first.shape[0] or a.shape[1:-2] != first.shape[1:-2]:
            raise ValueError(f"halo inputs disagree on leading axes: {a.shape} vs {first.shape}")
        if a.dtype != first.dtype:
            raise ValueError(f"halo inputs disagree on dtype: {a.dtype} vs {first.dtype}")
    arrays = {n: _lift(inputs[n]) for n in names}
    outs = halo_plain(arrays, plan, n_out)
    lead = (first.shape[0] if n_out is None else n_out,) + tuple(first.shape[1:-2])
    return {name: out.reshape(lead + tuple(out.shape[-2:])) for name, out in outs.items()}


# ---------------------------------------------------------------------------
# plain version: strip updates
# ---------------------------------------------------------------------------


def _compute_slab(op, srcs: Dict[str, torch.Tensor]) -> torch.Tensor:
    slab = None
    for cid, c in enumerate(op.classes):
        src_all = srcs[c.src_comp]
        sr0, sr1, sc0, sc1 = c.src_rect
        perm = torch.as_tensor(op.perm, dtype=torch.long, device=src_all.device)
        cand = src_all[..., sr0:sr1, sc0:sc1][perm]
        if c.rot_k:
            cand = torch.rot90(cand, k=c.rot_k, dims=(-2, -1))
        if c.sign != 1.0:
            cand = cand * c.sign
        if slab is None:
            slab = cand
        else:
            mask = torch.as_tensor(
                op.klass_of_shard == cid, device=src_all.device
            ).reshape((-1,) + (1,) * (cand.ndim - 1))
            slab = torch.where(mask, cand, slab)
    return slab


def halo_plain(arrays: Dict[str, torch.Tensor], plan: ExchangePlan,
               n_out=None) -> Dict[str, torch.Tensor]:
    """Plain PyTorch exchange on lifted ``(S, K, Y, X)`` inputs."""
    ref = arrays[sorted(arrays)[0]]
    S = ref.shape[0] if n_out is None else n_out
    outs = {}
    for name, src, shape in plan.outputs:
        if src is not None:
            out = arrays[src][:S].clone()
        else:
            out = torch.empty((S, ref.shape[1]) + tuple(shape), dtype=ref.dtype, device=ref.device)
        for oname, op in plan.ops:
            if oname == name:
                r0, r1, c0, c1 = op.dst_rect
                out[..., r0:r1, c0:c1] = _compute_slab(op, arrays)
        outs[name] = out
    return outs
