"""The fused C-grid tail CUDA kernel's wrapper.

Kernel source: ``csrc/c_sw_tail.cu`` (replaces
``pace_tpu/ops/c_sw_tail_pallas.py`` ``_kernel``). :func:`c_sw_tail_cuda`
takes the 14 fields of ``ops.c_sw.c_sw_tail_plain`` on the card and returns
its nine results; it counts its launches in :data:`LAUNCHES`.
``ops.c_sw.c_sw_tail`` picks one of the two by where its operands lie
(ops/_dispatch.py).

The kernel clamps its cell-to-interface reads exactly as the plain version's
edge-replicating pads do, so the two agree on the whole plane. It skips
``dedup_corner_divergence`` (the cube-corner average overwrites the same
points); ``c_sw_tail_plain(..., dedup=False)`` is that variant in plain
PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ._dispatch import check_operands
from .c_sw import divergence_edge_weights
from .corners import _FOLDED, _QUADRANTS

#: launches since the count was last reset
LAUNCHES = {"c_sw_tail": 0}

_FN = {torch.float32: "pace_c_sw_tail_f32", torch.float64: "pace_c_sw_tail_f64"}

FIELDS = ("u", "v", "delp", "pt", "uc", "vc", "uc_x", "vc_x", "uc_y", "vc_y",
          "ua", "va", "va_x", "ua_y")
#: constant planes in the kernel's argument order; the last four are derived
#: from the grid by ``divergence_edge_weights``
CONSTS = ("cosa_u", "rsin_u2", "cosa_v", "rsin_v2", "dx", "dy", "sin_sg_e",
          "sin_sg_w", "sin_sg_n", "sin_sg_s", "rarea", "dxc", "dyc", "rarea_c",
          "fC", "sina_u", "sina_v", "rdxc", "rdyc", "uedge_w", "vedge_w",
          "edge_y", "edge_x")

_CELL, _XI, _YI, _CORNER = (0, 0), (0, 1), (1, 0), (1, 1)
_FIELD_STAGGER = dict(
    u=_YI, v=_XI, delp=_CELL, pt=_CELL, uc=_XI, vc=_YI, uc_x=_XI, vc_x=_YI,
    uc_y=_XI, vc_y=_YI, ua=_CELL, va=_CELL, va_x=_CELL, ua_y=_CELL,
)
_CONST_STAGGER = dict(
    cosa_u=_XI, rsin_u2=_XI, cosa_v=_YI, rsin_v2=_YI, dx=_YI, dy=_XI,
    sin_sg_e=_CELL, sin_sg_w=_CELL, sin_sg_n=_CELL, sin_sg_s=_CELL, rarea=_CELL,
    dxc=_XI, dyc=_YI, rarea_c=_CORNER, fC=_CORNER, sina_u=_XI, sina_v=_YI,
    rdxc=_XI, rdyc=_YI, uedge_w=_YI, vedge_w=_XI,
)
#: staggering of the nine results (delpc, ptc, uc_new, vc_new, ut, vt, xfx,
#: yfx, divg_d)
OUT_STAGGER = (_CELL, _CELL, _XI, _YI, _XI, _YI, _XI, _YI, _CORNER)


def _fn(dtype):
    fn = getattr(_build.library("c_sw_tail"), _FN[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, ctypes.c_double, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return fn


def corner_arrays(table, S: int):
    """The static corner table as the kernel's int32 arrays: ``pos``
    (n, 2) corner indices, ``quad`` (n, 3, 2) offsets of the three real
    quadrants in ``_QUADRANTS`` order, ``own`` (n, S) ownership flags."""
    pos = [[jj, ii] for _kind, jj, ii, _own in table]
    quad = [[q for q in _QUADRANTS if q != _FOLDED[kind]] for kind, _jj, _ii, _own in table]
    own = [[int(o) for o in own] for _kind, _jj, _ii, own in table]
    i32 = lambda a, shape: torch.tensor(a, dtype=torch.int32).reshape(shape)  # noqa: E731
    n = len(table)
    return i32(pos, (n, 2)), i32(quad, (n, 3, 2)), i32(own, (n, S))


@functools.lru_cache(maxsize=8)
def _device_corner_arrays(table, S: int, device: str):
    return tuple(t.to(device) for t in corner_arrays(table, S))


def c_sw_tail_cuda(u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y,
                   ua, va, va_x, ua_y, grid, dt2: float):
    """Fused-kernel ``(delpc, ptc, uc_new, vc_new, ut, vt, xfx, yfx,
    divg_d)`` of 4-D CUDA fields."""
    if delp.ndim != 4:
        raise ValueError(f"c_sw tail kernel takes (S, K, Y, X) fields, got {tuple(delp.shape)}")
    S, K, Y, X = delp.shape
    fields = dict(zip(FIELDS, (u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y,
                               ua, va, va_x, ua_y)))
    consts = {n: getattr(grid, n) for n in CONSTS[:19]}
    consts.update(zip(CONSTS[19:], divergence_edge_weights(grid)))
    named = [(n, t, (S, K, Y + _FIELD_STAGGER[n][0], X + _FIELD_STAGGER[n][1]))
             for n, t in fields.items()]
    named += [(n, consts[n], (S, Y + dy, X + dx)) for n, (dy, dx) in _CONST_STAGGER.items()]
    named += [("edge_y", consts["edge_y"], (S, Y + 1, 1)),
              ("edge_x", consts["edge_x"], (S, 1, X + 1))]
    check_operands("c_sw tail kernel", named, delp)
    outs = tuple(
        torch.empty((S, K, Y + dy, X + dx), dtype=delp.dtype, device=delp.device)
        for dy, dx in OUT_STAGGER
    )
    table = tuple(grid.corner_table)
    pos, quad, own = _device_corner_arrays(table, S, str(delp.device))
    order = [fields[n] for n in FIELDS] + [consts[n] for n in CONSTS] + list(outs)
    ptrs = (ctypes.c_void_p * len(order))(*(t.data_ptr() for t in order))
    rc = _fn(delp.dtype)(
        ptrs, float(dt2), pos.data_ptr(), quad.data_ptr(), own.data_ptr(), len(table),
        S, K, Y, X, _build.stream_handle(delp.device),
    )
    _build.check(rc, "c_sw tail kernel")
    LAUNCHES["c_sw_tail"] += 1
    return outs
