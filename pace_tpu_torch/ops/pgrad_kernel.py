"""The nonhydrostatic D-grid pressure gradient's CUDA kernel wrapper.

Kernel source: ``csrc/pgrad.cu`` (replaces ``pace_tpu/ops/pgrad_pallas.py``
``_kernel``). :func:`nh_p_grad_cuda` takes the operands of
``ops.nonhydro.nh_p_grad`` on the card and returns its ``(u_new, v_new)``; it
counts its launches in :data:`LAUNCHES`. ``ops.nonhydro.nh_p_grad_best``
picks one of the two by where its operands lie (ops/_dispatch.py).

The kernel repeats ``ops.pgrad.a2b_ord4`` op for op on every corner whose
4x4 stencil lies inside the array, blends included, and sums ``(u + du_h) +
du_p`` as the plain version does; it reads the grid's edge flags, ghost
weights and corner table as they are, so any shard layout works. Each block
classifies its tile once; :func:`tile_classes` states the rule.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ._dispatch import check_operands
from .c_sw_tail_kernel import _device_corner_arrays

#: launches since the count was last reset
LAUNCHES = {"pgrad": 0}

_FN = {torch.float32: "pace_pgrad_f32", torch.float64: "pace_pgrad_f64"}

#: grid arrays in the kernel's argument order, with their (dy, dx) extent
#: beyond (Y, X); the edge vectors are (S, 1, X+1) or (S, Y+1, 1)
GRID_FIELDS = (
    ("rdx", (1, 0)), ("rdy", (0, 1)),
    ("edge_w_iface", None), ("edge_e_iface", None), ("edge_s_iface", None),
    ("edge_n_iface", None), ("a2b_ghost_left_x", None), ("a2b_ghost_south_y", None),
    ("a2b_x_w0", (0, 1)), ("a2b_x_wp", (0, 1)), ("a2b_x_wm", (0, 1)),
    ("a2b_y_w0", (1, 0)), ("a2b_y_wp", (1, 0)), ("a2b_y_wm", (1, 0)),
)
_X_LINES = ("edge_w_iface", "edge_e_iface", "a2b_ghost_left_x")

#: the kernel's tile of u/v points, rows by columns (``TY``, ``TX`` of
#: csrc/pgrad.cu); a tile's corner points are rows j0 .. j0+TY and columns
#: i0 .. i0+TX
TILE = (16, 32)


def _fn(dtype):
    fn = getattr(_build.library("pgrad"), _FN[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, ctypes.c_double, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return fn


def grid_operands(grid, S: int, Y: int, X: int):
    """``(name, tensor, shape)`` of the grid arrays the kernel reads."""
    out = []
    for name, ext in GRID_FIELDS:
        if ext is not None:
            shape = (S, Y + ext[0], X + ext[1])
        else:
            shape = (S, 1, X + 1) if name in _X_LINES else (S, Y + 1, 1)
        out.append((name, getattr(grid, name), shape))
    return out


def tile_classes(grid, S: int, Y: int, X: int):
    """The tiles that take the kernel's edge path: ``(S, tiles_y, tiles_x)``
    booleans, True where the tile's corner points meet a W/E tile-edge line
    or the first line inside one (the one-sided cubic), an S/N tile-edge
    row, or a cube corner of the shard. Every other tile takes the path with
    no blends; this is the kernel's own test, kept here so that a run can
    find the seams between the two."""
    TY, TX = TILE
    ny, nx = -(-(Y + 1) // TY), -(-(X + 1) // TX)
    ew, ee = (getattr(grid, n).reshape(S, X + 1) for n in ("edge_w_iface", "edge_e_iface"))
    es, en = (getattr(grid, n).reshape(S, Y + 1) for n in ("edge_s_iface", "edge_n_iface"))
    x_line = ((ew + ee) != 0) | (torch.roll(ew, 1, -1) != 0) | (torch.roll(ee, -1, -1) != 0)
    y_line = (es + en) != 0
    edge = torch.zeros((S, ny, nx), dtype=torch.bool, device=ew.device)
    for a in range(ny):
        edge[:, a, :] |= y_line[:, a * TY:a * TY + TY + 1].any(-1)[:, None]
    for b in range(nx):
        edge[:, :, b] |= x_line[:, b * TX:b * TX + TX + 1].any(-1)[:, None]
    for _kind, jj, ii, own in grid.corner_table:
        for s in range(S):
            for a in range(ny):
                for b in range(nx):
                    if (own[s] and a * TY <= jj <= a * TY + TY
                            and b * TX <= ii <= b * TX + TX):
                        edge[s, a, b] = True
    return edge


def nh_p_grad_cuda(u, v, pk, gz, pp, delp, grid, dt: float):
    """Fused-kernel ``(u_new, v_new)`` of CUDA tensors: ``pk, gz, pp``
    ``(S, K+1, Y, X)``, ``delp (S, K, Y, X)``, ``u (S, K, Y+1, X)``, ``v (S,
    K, Y, X+1)``."""
    if delp.ndim != 4:
        raise ValueError(f"pgrad kernel takes (S, K, Y, X) fields, got {tuple(delp.shape)}")
    S, K, Y, X = delp.shape
    named = [("pk", pk, (S, K + 1, Y, X)), ("gz", gz, (S, K + 1, Y, X)),
             ("pp", pp, (S, K + 1, Y, X)), ("delp", delp, (S, K, Y, X)),
             ("u", u, (S, K, Y + 1, X)), ("v", v, (S, K, Y, X + 1))]
    consts = grid_operands(grid, S, Y, X)
    check_operands("pgrad kernel", named + consts, delp)
    u_new, v_new = torch.empty_like(u), torch.empty_like(v)
    table = tuple(grid.corner_table)
    pos, quad, own = _device_corner_arrays(table, S, str(delp.device))
    order = [t for _n, t, _s in named + consts] + [u_new, v_new]
    ptrs = (ctypes.c_void_p * len(order))(*(t.data_ptr() for t in order))
    rc = _fn(delp.dtype)(
        ptrs, float(dt), pos.data_ptr(), quad.data_ptr(), own.data_ptr(), len(table),
        S, K, Y, X, _build.stream_handle(delp.device),
    )
    _build.check(rc, "pgrad kernel")
    LAUNCHES["pgrad"] += 1
    return u_new, v_new
