"""The fused d2a2c CUDA kernel's wrapper.

Kernel source: ``csrc/d2a2c.cu`` (replaces ``pace_tpu/ops/d2a2c_pallas.py``
``_kernel``). :func:`d2a2c_cuda` takes the D-grid winds ``u (S, K, Y+1, X)``
and ``v (S, K, Y, X+1)`` on the card and returns ``(ua, va, uc, vc, ut,
vt)`` like the plain version ``ops.d2a2c.d2a2c_plain``; it counts its
launches in :data:`LAUNCHES`. ``ops.d2a2c.d2a2c_vect`` picks one of the two
by where its operands lie (ops/_dispatch.py).

Unspecified values: the kernel reads cells beyond the plane clamped to its
edge where the plain version's pads and rolls leave other values, so the
two differ in the outer two rows and columns of ``uc``, ``vc`` and the
outer three of ``ut``, ``vt`` (no consumer reads them); ``ua``, ``va``
agree on the whole plane. The last interface column of ``uc``/``ut`` and
row of ``vc``/``vt`` is zero.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ._dispatch import check_operands
from .d2a2c import GRID_FIELDS

#: launches since the count was last reset
LAUNCHES = {"d2a2c": 0}

_FN = {torch.float32: "pace_d2a2c_f32", torch.float64: "pace_d2a2c_f64"}


def _fn(dtype):
    fn = getattr(_build.library("d2a2c"), _FN[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, P]
        fn.restype = I
    return fn


def grid_shapes(S: int, Y: int, X: int) -> dict:
    """Shape of every grid field the kernel reads, for ``(Y, X)`` cells."""
    return {
        "rsin2": (S, Y, X), "cosa_s": (S, Y, X), "band_c": (S, Y, X),
        "cosa_u": (S, Y, X + 1), "rsin_u2": (S, Y, X + 1),
        "cosa_v": (S, Y + 1, X), "rsin_v2": (S, Y + 1, X),
        "ec1": (S, 3, Y, X), "ec2": (S, 3, Y, X),
        "ew1": (S, 3, Y, X + 1), "ew2": (S, 3, Y, X + 1),
        "es1": (S, 3, Y + 1, X), "es2": (S, 3, Y + 1, X),
        "minv": (S, 3, 3, Y, X),
    }


def d2a2c_cuda(u, v, grid):
    """Fused-kernel ``(ua, va, uc, vc, ut, vt)`` of 4-D CUDA winds."""
    if u.ndim != 4:
        raise ValueError(f"d2a2c kernel takes (S, K, Y+1, X) winds, got {tuple(u.shape)}")
    S, K, Y1, X = u.shape
    Y = Y1 - 1
    shapes = grid_shapes(S, Y, X)
    consts = [getattr(grid, f) for f in GRID_FIELDS]
    check_operands(
        "d2a2c kernel",
        [("u", u, (S, K, Y + 1, X)), ("v", v, (S, K, Y, X + 1))]
        + [(f, t, shapes[f]) for f, t in zip(GRID_FIELDS, consts)],
        u,
    )
    new = lambda *sh: torch.empty(sh, dtype=u.dtype, device=u.device)  # noqa: E731
    outs = (
        new(S, K, Y, X), new(S, K, Y, X),
        new(S, K, Y, X + 1), new(S, K, Y + 1, X),
        new(S, K, Y, X + 1), new(S, K, Y + 1, X),
    )
    ua, va, uc, vc, ut, vt = outs
    order = [u, v, *consts, ua, va, uc, vc, ut, vt]
    ptrs = (ctypes.c_void_p * len(order))(*(t.data_ptr() for t in order))
    rc = _fn(u.dtype)(ptrs, S, K, Y, X, _build.stream_handle(u.device))
    _build.check(rc, "d2a2c kernel")
    LAUNCHES["d2a2c"] += 1
    return outs
