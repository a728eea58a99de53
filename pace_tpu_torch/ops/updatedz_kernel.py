"""The interface-height CUDA kernels' wrappers.

Kernel source: ``csrc/updatedz.cu`` (replaces
``pace_tpu/ops/updatedz_pallas.py`` ``_heights_kernel``,
``_updatedzc_kernel`` and ``_flux_update_kernel``).
:func:`heights_from_delz_cuda`, :func:`updatedz_c_cuda` and
:func:`flux_height_update_cuda` take CUDA tensors and count their launches in
:data:`LAUNCHES`; ``ops.nonhydro.heights_from_delz``,
``ops.nonhydro.updatedz_c`` and ``ops.nonhydro.flux_height_update`` pick them
or the plain versions by where their operands lie (ops/_dispatch.py).

The kernels keep the plain versions' operation order (the column sum is
built first and then subtracted from the surface height; the cell-to-interface
reads clamp as the edge-replicating pads do; the flux update sums left to
right), so they agree with them on the whole plane.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, constants
from ._dispatch import check_operands

#: launches since the count was last reset
LAUNCHES = {"heights": 0, "updatedz_c": 0, "flux_height_update": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _fn(name: str, dtype, argtypes):
    fn = getattr(_build.library("updatedz"), f"pace_{name}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def heights_from_delz_cuda(delz, phis):
    """Column-kernel interface heights ``zh (S, K+1, Y, X)`` of CUDA ``delz
    (S, K, Y, X)`` and ``phis (S, Y, X)``."""
    if delz.ndim != 4:
        raise ValueError(f"heights kernel takes (S, K, Y, X) fields, got {tuple(delz.shape)}")
    S, K, Y, X = delz.shape
    check_operands("heights kernel", [("delz", delz, (S, K, Y, X)), ("phis", phis, (S, Y, X))],
                   delz)
    zh = torch.empty((S, K + 1, Y, X), dtype=delz.dtype, device=delz.device)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rc = _fn("heights", delz.dtype, [P, P, D, P, I, I, I, P])(
        delz.data_ptr(), phis.data_ptr(), constants.GRAV, zh.data_ptr(), S, K, Y * X,
        _build.stream_handle(delz.device),
    )
    _build.check(rc, "heights kernel")
    LAUNCHES["heights"] += 1
    return zh


def updatedz_c_cuda(zh_x, zh_y, xfx_l, yfx_l, area, dt2: float):
    """Kernel ``(zh_new (S, K+1, Y, X), ws_c (S, Y, X))`` of CUDA interface
    heights ``zh_x, zh_y (S, K+1, Y, X)``, layer area fluxes ``xfx_l (S, K, Y,
    X+1)``, ``yfx_l (S, K, Y+1, X)`` and ``area (S, Y, X)``."""
    if zh_x.ndim != 4:
        raise ValueError(f"updatedz_c kernel takes (S, K+1, Y, X) heights, got "
                         f"{tuple(zh_x.shape)}")
    S, K1, Y, X = zh_x.shape
    K = K1 - 1
    if K < 1:
        raise ValueError("updatedz_c kernel needs at least one layer")
    if K1 * (Y + 1) * (X + 1) >= 2**31:
        raise ValueError(f"updatedz_c kernel: a column's {K1} x {Y} x {X} offsets beyond 32 bits")
    check_operands(
        "updatedz_c kernel",
        [("zh_x", zh_x, (S, K1, Y, X)), ("zh_y", zh_y, (S, K1, Y, X)),
         ("xfx", xfx_l, (S, K, Y, X + 1)), ("yfx", yfx_l, (S, K, Y + 1, X)),
         ("area", area, (S, Y, X))],
        zh_x,
    )
    zh_new = torch.empty_like(zh_x)
    ws = torch.empty((S, Y, X), dtype=zh_x.dtype, device=zh_x.device)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rc = _fn("updatedz_c", zh_x.dtype, [P, P, P, P, P, D, P, P, I, I, I, I, P])(
        zh_x.data_ptr(), zh_y.data_ptr(), xfx_l.data_ptr(), yfx_l.data_ptr(), area.data_ptr(),
        float(dt2), zh_new.data_ptr(), ws.data_ptr(), S, K, Y, X,
        _build.stream_handle(zh_x.device),
    )
    _build.check(rc, "updatedz_c kernel")
    LAUNCHES["updatedz_c"] += 1
    return zh_new, ws


def flux_height_update_cuda(zh, fx, fy, xfx_i, yfx_i, area):
    """Kernel ``zh_new (S, K+1, Y, X)``, the tail of ``updatedz_d``: ``(zh
    area + flux divergence of fx, fy) / (area + flux divergence of xfx_i,
    yfx_i)`` of CUDA interface heights ``zh``, their fluxes ``fx, xfx_i (S,
    K+1, Y, X+1)``, ``fy, yfx_i (S, K+1, Y+1, X)`` and ``area (S, Y, X)``."""
    if zh.ndim != 4:
        raise ValueError(f"flux_height_update kernel takes (S, K+1, Y, X) heights, got "
                         f"{tuple(zh.shape)}")
    S, K1, Y, X = zh.shape
    if S * K1 > 65535:
        raise ValueError(f"flux_height_update kernel: S * (K+1) = {S * K1} beyond 65535 blocks")
    check_operands(
        "flux_height_update kernel",
        [("zh", zh, (S, K1, Y, X)), ("fx", fx, (S, K1, Y, X + 1)),
         ("fy", fy, (S, K1, Y + 1, X)), ("xfx_i", xfx_i, (S, K1, Y, X + 1)),
         ("yfx_i", yfx_i, (S, K1, Y + 1, X)), ("area", area, (S, Y, X))],
        zh,
    )
    out = torch.empty_like(zh)
    P, I = ctypes.c_void_p, ctypes.c_int
    rc = _fn("flux_height_update", zh.dtype, [P] * 7 + [I] * 4 + [P])(
        zh.data_ptr(), fx.data_ptr(), fy.data_ptr(), xfx_i.data_ptr(), yfx_i.data_ptr(),
        area.data_ptr(), out.data_ptr(), S, K1, Y, X, _build.stream_handle(zh.device),
    )
    _build.check(rc, "flux_height_update kernel")
    LAUNCHES["flux_height_update"] += 1
    return out
