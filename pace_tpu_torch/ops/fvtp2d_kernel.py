"""The fused fvtp2d CUDA kernel's wrappers and their plain versions.

Kernel source: ``csrc/fvtp2d.cu`` (replaces ``pace_tpu/ops/fvtp2d_pallas.py``
``_kernel``, ``_kernel_multi`` and ``_kernel_tracer``). Three wrappers launch
it:

- :func:`fvtp2d_cuda`: one field ``(S, K, Y, X)``, one hord, weights
  ``xfx/yfx`` or mass fluxes ``mfx/mfy``;
- :func:`fvtp2d_multi_cuda`: up to :data:`MAX_FIELDS` separate fields that
  share the winds, each with its own hord, weighting and y-fold form, in one
  launch (d_sw's pt/vorticity/w);
- :func:`fvtp2d_tracer_cuda`: a stacked tracer block ``(S, nq, K, Y, X)``
  weighted by the mass fluxes, all tracers sharing the winds.

Each counts its launches in :data:`LAUNCHES`. The plain versions
(:func:`fvtp2d_plain`, :func:`fvtp2d_multi_plain`,
:func:`fvtp2d_tracer_plain`) are the ``ops/fvtp2d.py`` formulation;
:func:`fvtp2d_tracer` and ``ops.fvtp2d.fvtp2d_multi_best`` pick one of the
two by where their operands lie (ops/_dispatch.py).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dtypes import SUPPORTED
from ._dispatch import check_operands, route
from .folds import CornerPatch
from .fvtp2d import fvtp2d
from .ppm import SUPPORTED_HORDS

#: launches per wrapper since the count was last reset
LAUNCHES = {"fvtp2d": 0, "fvtp2d_tracer": 0, "fvtp2d_multi": 0}

_FN = {torch.float32: "pace_fvtp2d_f32", torch.float64: "pace_fvtp2d_f64"}
_FN_TRACER = {torch.float32: "pace_fvtp2d_tracer_f32", torch.float64: "pace_fvtp2d_tracer_f64"}
_FN_MULTI = {torch.float32: "pace_fvtp2d_multi_f32", torch.float64: "pace_fvtp2d_multi_f64"}

#: most fields one multi-field launch takes
MAX_FIELDS = 4


def _fn(dtype, names=_FN):
    lib = _build.library("fvtp2d")
    fn = getattr(lib, names[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I] + [P] * 9 + [I] * 6 + [P]
        fn.restype = I
    return fn


def _launch(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord, names=_FN):
    """qx: (S, NQ, K, Y, X); operands (S, K, ·, ·); returns 5-D fx, fy.
    ``names``: the C entry by dtype (the single-field kernel's, which also
    takes a block of NQ tracers with one block per tracer, or the tracer
    kernel's)."""
    if hord not in SUPPORTED_HORDS:
        raise ValueError(f"unsupported hord {hord}; choose from {SUPPORTED_HORDS}")
    S, NQ, K, Y, X = qx.shape
    patch = isinstance(qy, CornerPatch)
    qy_t = qy.data if patch else qy
    h = qy_t.shape[-1] // 2 if patch else 0
    want = {
        "qx": (qx, (S, NQ, K, Y, X)),
        "qy": (qy_t, (S, NQ, K, 2 * h, 2 * h) if patch else (S, NQ, K, Y, X)),
        "crx": (crx, (S, K, Y, X + 1)),
        "cry": (cry, (S, K, Y + 1, X)),
        "xfx": (xfx, (S, K, Y, X + 1)),
        "yfx": (yfx, (S, K, Y + 1, X)),
        "area": (area, (S, Y, X)),
    }
    if mfx is not None or mfy is not None:
        want["mfx"] = (mfx, (S, K, Y, X + 1))
        want["mfy"] = (mfy, (S, K, Y + 1, X))
    if qx.dtype not in SUPPORTED:
        raise ValueError(f"fvtp2d kernel takes {SUPPORTED}, got {qx.dtype}")
    for name, (t, shape) in want.items():
        if t is None:
            raise ValueError(f"fvtp2d kernel: {name} missing")
        if tuple(t.shape) != shape:
            raise ValueError(f"fvtp2d kernel: {name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != qx.dtype or t.device != qx.device or t.device.type != "cuda":
            raise ValueError(f"fvtp2d kernel: {name} must be a {qx.dtype} tensor on {qx.device}")
        if not t.is_contiguous():
            raise ValueError(f"fvtp2d kernel: {name} must be contiguous")
    fx = torch.empty((S, NQ, K, Y, X + 1), dtype=qx.dtype, device=qx.device)
    fy = torch.empty((S, NQ, K, Y + 1, X), dtype=qx.dtype, device=qx.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _fn(qx.dtype, names)(
        qx.data_ptr(), qy_t.data_ptr(), int(patch), h,
        crx.data_ptr(), cry.data_ptr(), xfx.data_ptr(), yfx.data_ptr(),
        area.data_ptr(), ptr(mfx), ptr(mfy), fx.data_ptr(), fy.data_ptr(),
        S, NQ, K, Y, X, int(hord), _build.stream_handle(qx.device),
    )
    _build.check(rc, "fvtp2d kernel")
    return fx, fy


def fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, area, hord: int, mfx=None, mfy=None):
    """Fused-kernel fluxes of one field ``(S, K, Y, X)``; ``qy`` a full
    tensor or a CornerPatch ``(S, K, 2h, 2h)``. Returns ``(fx, fy)`` at
    interface sizes, the outermost interface col/row zero."""
    qy1 = CornerPatch(qy.data[:, None]) if isinstance(qy, CornerPatch) else qy[:, None]
    fx, fy = _launch(qx[:, None], qy1, crx, cry, xfx, yfx, area, mfx, mfy, hord)
    LAUNCHES["fvtp2d"] += 1
    return fx[:, 0], fy[:, 0]


def _fn_multi(dtype):
    fn = getattr(_build.library("fvtp2d"), _FN_MULTI[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I] + [P] * 7 + [I] * 4 + [P]
        fn.restype = I
    return fn


def check_multi_fields(fields, mfx, mfy):
    """Raise unless ``fields`` is 1 to :data:`MAX_FIELDS` tuples ``(qx, qy,
    hord, use_mf)`` of one shape and dtype with supported hords, one corner
    pack width, and mass fluxes present where a field asks for them. Returns
    the half width ``h`` of the corner packs (0 when every ``qy`` is full)."""
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"fvtp2d multi takes 1 to {MAX_FIELDS} fields, got {len(fields)}")
    q0 = fields[0][0]
    h = 0
    for qx, qy, hord, use_mf in fields:
        patch = isinstance(qy, CornerPatch)
        qy_t = qy.data if patch else qy
        if qx.shape != q0.shape or (not patch and qy_t.shape != q0.shape):
            raise ValueError(f"fvtp2d multi: all fields must share shape {tuple(q0.shape)}, "
                             f"got {tuple(qx.shape)}/{tuple(qy_t.shape)}")
        if qx.dtype != q0.dtype or qy_t.dtype != q0.dtype:
            raise ValueError(f"fvtp2d multi: all fields must share dtype {q0.dtype}, "
                             f"got {qx.dtype}/{qy_t.dtype}")
        if hord not in SUPPORTED_HORDS:
            raise ValueError(f"unsupported hord {hord}; choose from {SUPPORTED_HORDS}")
        if use_mf and (mfx is None or mfy is None):
            raise ValueError("fvtp2d multi: a field asks for mass-flux weights, mfx/mfy missing")
        if patch:
            if h and qy_t.shape[-1] != 2 * h:
                raise ValueError("fvtp2d multi: corner packs of different widths")
            h = qy_t.shape[-1] // 2
    return h


def fvtp2d_multi_cuda(fields, crx, cry, xfx, yfx, area, mfx=None, mfy=None):
    """Fused-kernel fluxes of several fields ``(S, K, Y, X)`` sharing the
    winds, in one launch. ``fields``: ``(qx, qy, hord, use_mf)`` tuples,
    ``qy`` a full tensor or a CornerPatch ``(S, K, 2h, 2h)``. Returns a list
    of ``(fx, fy)`` in field order, each bit-identical to the single-field
    :func:`fvtp2d_cuda` call."""
    h = check_multi_fields(fields, mfx, mfy)
    q0 = fields[0][0]
    if q0.ndim != 4:
        raise ValueError(f"fvtp2d multi kernel takes (S, K, Y, X) fields, got {tuple(q0.shape)}")
    S, K, Y, X = q0.shape
    named = [("crx", crx, (S, K, Y, X + 1)), ("cry", cry, (S, K, Y + 1, X)),
             ("xfx", xfx, (S, K, Y, X + 1)), ("yfx", yfx, (S, K, Y + 1, X)),
             ("area", area, (S, Y, X))]
    if mfx is not None or mfy is not None:
        if mfx is None or mfy is None:
            raise ValueError("fvtp2d multi kernel: mfx and mfy come together")
        named += [("mfx", mfx, (S, K, Y, X + 1)), ("mfy", mfy, (S, K, Y + 1, X))]
    ptrs, modes, outs = [], [], []
    for n, (qx, qy, hord, use_mf) in enumerate(fields):
        patch = isinstance(qy, CornerPatch)
        qy_t = qy.data if patch else qy
        named += [(f"qx[{n}]", qx, (S, K, Y, X)),
                  (f"qy[{n}]", qy_t, (S, K, 2 * h, 2 * h) if patch else (S, K, Y, X))]
        fx = torch.empty((S, K, Y, X + 1), dtype=q0.dtype, device=q0.device)
        fy = torch.empty((S, K, Y + 1, X), dtype=q0.dtype, device=q0.device)
        outs.append((fx, fy))
        ptrs += [qx.data_ptr(), qy_t.data_ptr(), fx.data_ptr(), fy.data_ptr()]
        modes += [int(patch), int(hord), int(bool(use_mf))]
    check_operands("fvtp2d multi kernel", named, q0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _fn_multi(q0.dtype)(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(modes))(*modes),
        len(fields), h, crx.data_ptr(), cry.data_ptr(), xfx.data_ptr(), yfx.data_ptr(),
        area.data_ptr(), ptr(mfx), ptr(mfy), S, K, Y, X, _build.stream_handle(q0.device),
    )
    _build.check(rc, "fvtp2d multi kernel")
    LAUNCHES["fvtp2d_multi"] += 1
    return outs


def fvtp2d_multi_plain(fields, crx, cry, xfx, yfx, area, mfx=None, mfy=None):
    """Plain PyTorch version of :func:`fvtp2d_multi_cuda`: the single-field
    formulation, one field at a time."""
    check_multi_fields(fields, mfx, mfy)
    return [
        fvtp2d_plain(qx, qy, crx, cry, xfx, yfx, area, hord,
                     mfx=mfx if use_mf else None, mfy=mfy if use_mf else None)
        for qx, qy, hord, use_mf in fields
    ]


def fvtp2d_tracer_cuda(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord: int):
    """Mass-flux-weighted fused-kernel fluxes of a tracer block ``(S, nq,
    K, Y, X)``; ``qy`` a full block or a CornerPatch ``(S, nq, K, 2h, 2h)``.
    One launch of the tracer kernel, whose blocks walk all ``nq`` tracers;
    each tracer's fluxes equal the single-field launch's bit for bit."""
    out = _launch(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord, _FN_TRACER)
    LAUNCHES["fvtp2d_tracer"] += 1
    return out


def fvtp2d_plain(qx, qy, crx, cry, xfx, yfx, area, hord: int, mfx=None, mfy=None):
    """Plain PyTorch version of :func:`fvtp2d_cuda` (the fvtp2d formulation)."""
    fl = fvtp2d(qx, qy, crx, cry, xfx, yfx, area, hord, mfx=mfx, mfy=mfy)
    return fl.fx, fl.fy


def fvtp2d_tracer_plain(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord: int):
    """Plain PyTorch version of :func:`fvtp2d_tracer_cuda`, one tracer at a
    time (the formulation's intermediates exist for one tracer only)."""
    fxs, fys = [], []
    for t in range(qx.shape[1]):
        qy_t = CornerPatch(qy.data[:, t]) if isinstance(qy, CornerPatch) else qy[:, t]
        fx, fy = fvtp2d_plain(
            qx[:, t], qy_t, crx, cry, xfx, yfx, area, hord, mfx=mfx, mfy=mfy
        )
        fxs.append(fx)
        fys.append(fy)
    return torch.stack(fxs, dim=1), torch.stack(fys, dim=1)


def fvtp2d_tracer(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord: int):
    """Tracer-block fluxes: the kernel for CUDA tensors, else the plain
    version."""
    qy_t = qy.data if isinstance(qy, CornerPatch) else qy
    if route(qx, qy_t, crx, cry, xfx, yfx, area, mfx, mfy) == "kernel":
        return fvtp2d_tracer_cuda(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord)
    return fvtp2d_tracer_plain(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord)
