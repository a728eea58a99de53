"""Application of halo-exchange region ops: the CUDA gather kernel and its
plain version.

Kernel source: ``csrc/halo.cu`` (replaces ``pace_tpu/parallel/halo_pallas.py``
``_halo_kernel``). An :class:`ExchangePlan` names the outputs of one
exchange — each a copy of one input with its ghost regions rewritten, or a
region-only output such as the y-fold corner pack — and the region ops that
write them. Inputs and outputs are ``(S, ..., Y, X)``; the middle axes are
flattened into one level axis K (a 3-D field has K = 1).

- :func:`halo_cuda` resolves the plan once per (output, input shapes,
  device) into a per-point index map and runs one gather pass per output;
  it counts its launches in :data:`LAUNCHES`.
- :func:`halo_plain` applies the ops as strip updates (``pace_tpu``'s
  ``_assemble_dus``).
- :func:`exchange` picks one by where the inputs lie (ops/_dispatch.py).

Both return new tensors; the inputs are never written. An exchange writes
``n_out`` shards (all of the inputs' by default): the distributed exchange
(``halo_shardmap.py``) gives a rank's own shards followed by the shards it
received, and a plan whose shard indices are re-based onto that source.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from ..dtypes import SUPPORTED
from ..ops._dispatch import route

#: launches of the gather kernel since the count was last reset
LAUNCHES = {"halo": 0}

_FN = {torch.float32: "pace_halo_gather_f32", torch.float64: "pace_halo_gather_f64"}


@dataclasses.dataclass(eq=False)
class ExchangePlan:
    """``outputs``: ``(name, source input name, None)`` for a copy-through
    output, ``(name, None, (y, x))`` for a region-only output whose every
    point is written by its ops. ``ops``: ``(output name, region op)`` in
    application order; an op's classes name input components as sources."""

    outputs: Tuple
    ops: Tuple
    #: (output, input planes, S, device) -> (off, meta) int32 index maps
    maps: Dict = dataclasses.field(default_factory=dict, repr=False)


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
    if route(*arrays.values()) == "kernel":
        outs = halo_cuda(arrays, plan, n_out)
    else:
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


# ---------------------------------------------------------------------------
# CUDA kernel: per-point index maps + one gather pass per output
# ---------------------------------------------------------------------------


def index_map(plan: ExchangePlan, name: str, planes: Dict[str, Tuple[int, int]], S: int):
    """Host-side map of output ``name``: ``off[s, y, x]`` (offset in the
    source plane) and ``meta[s, y, x]`` = ``(source shard << 2) | (input id
    << 1) | negate``, input ids in sorted-name order. Later ops win where
    rects overlap, as in the strip updates."""
    in_id = {n: i for i, n in enumerate(sorted(planes))}
    src, shape = next((s, sh) for n, s, sh in plan.outputs if n == name)
    Yo, Xo = planes[src] if src is not None else shape
    if src is not None:
        jj, ii = np.meshgrid(np.arange(Yo), np.arange(Xo), indexing="ij")
        # np.array(..., order="C"): a copy of a broadcast view is not
        # C-ordered by default, and the kernel reads the maps as flat arrays
        off = np.array(np.broadcast_to(jj * Xo + ii, (S, Yo, Xo)), np.int64, order="C")
        meta = (np.arange(S)[:, None, None] << 2) | (in_id[src] << 1)
        meta = np.array(np.broadcast_to(meta, (S, Yo, Xo)), np.int64, order="C")
    else:
        off = np.full((S, Yo, Xo), -1, dtype=np.int64)
        meta = np.full((S, Yo, Xo), -1, dtype=np.int64)
    for oname, op in plan.ops:
        if oname != name:
            continue
        r0, r1, c0, c1 = op.dst_rect
        for s in range(S):
            c = op.classes[int(op.klass_of_shard[s])]
            sr0, sr1, sc0, sc1 = c.src_rect
            Xi = planes[c.src_comp][1]
            jj, ii = np.meshgrid(np.arange(sr0, sr1), np.arange(sc0, sc1), indexing="ij")
            off[s, r0:r1, c0:c1] = np.rot90(jj * Xi + ii, c.rot_k)
            meta[s, r0:r1, c0:c1] = (
                (int(op.perm[s]) << 2) | (in_id[c.src_comp] << 1) | int(c.sign < 0)
            )
    if (off < 0).any():
        raise AssertionError(f"halo output {name!r}: points not covered by any op")
    if off.max() >= 2**31 or meta.max() >= 2**31:
        raise ValueError("halo index map overflows int32")
    return np.ascontiguousarray(off, np.int32), np.ascontiguousarray(meta, np.int32)


def _device_maps(plan, name, planes, S, device):
    key = (name, tuple(sorted(planes.items())), S, str(device))
    m = plan.maps.get(key)
    if m is None:
        off, meta = index_map(plan, name, planes, S)
        m = plan.maps[key] = (
            torch.from_numpy(off).to(device),
            torch.from_numpy(meta).to(device),
        )
    return m


def _fn(dtype):
    fn = getattr(_build.library("halo"), _FN[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, P, I, P, P, I, I, P]
        fn.restype = I
    return fn


def halo_cuda(arrays: Dict[str, torch.Tensor], plan: ExchangePlan,
              n_out=None) -> Dict[str, torch.Tensor]:
    """Kernel exchange on lifted ``(S, K, Y, X)`` CUDA inputs (at most two),
    writing the first ``n_out`` shards."""
    names = sorted(arrays)
    if len(names) > 2:
        raise ValueError(f"halo kernel takes at most two inputs, got {names}")
    ref = arrays[names[0]]
    if ref.dtype not in SUPPORTED:
        raise ValueError(f"halo kernel takes {SUPPORTED}, got {ref.dtype}")
    for n in names:
        a = arrays[n]
        if a.device.type != "cuda" or a.device != ref.device:
            raise ValueError(f"halo kernel: input {n} must lie on {ref.device}")
        if not a.is_contiguous():
            raise ValueError(f"halo kernel: input {n} must be contiguous")
    K = ref.shape[1]
    S = ref.shape[0] if n_out is None else n_out
    planes = {n: tuple(arrays[n].shape[-2:]) for n in names}
    in0 = arrays[names[0]]
    in1 = arrays[names[-1]]
    P0 = planes[names[0]][0] * planes[names[0]][1]
    P1 = planes[names[-1]][0] * planes[names[-1]][1]
    fn = _fn(ref.dtype)
    stream = _build.stream_handle(ref.device)
    outs = {}
    for name, src, shape in plan.outputs:
        Yo, Xo = planes[src] if src is not None else shape
        off, meta = _device_maps(plan, name, planes, S, ref.device)
        out = torch.empty((S, K, Yo, Xo), dtype=ref.dtype, device=ref.device)
        rc = fn(
            in0.data_ptr(), in1.data_ptr(), P0, P1, out.data_ptr(), Yo * Xo,
            off.data_ptr(), meta.data_ptr(), S, K, stream,
        )
        _build.check(rc, "halo kernel")
        LAUNCHES["halo"] += 1
        outs[name] = out
    return outs
