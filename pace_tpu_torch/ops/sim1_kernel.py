"""The semi-implicit vertical solve's CUDA kernel wrapper.

Kernel source: ``csrc/sim1.cu`` (replaces ``pace_tpu/ops/sim1_pallas.py``
``_sim1_kernel``). :func:`sim1_solver_cuda` is the backward-Euler
(``a_imp == 1``) solve of ``ops.nonhydro.sim1_solver`` with the ``p_fac``
floor of ``ops.nonhydro._p_fac_floor`` applied inside; it counts its launches
in :data:`LAUNCHES`. ``ops.nonhydro.sim1_solver_best`` picks it or the plain
version by where its operands lie (ops/_dispatch.py).

The kernel keeps the plain version's operation order and sums ``delp``
sequentially in k. ``pprime = p_full - p_hyd`` cancels two numbers near 1e5
Pa, so where ``log`` or the cumulative sum of the plain version round
differently on the card, ``pp`` and ``w`` differ from it by that ulp amplified;
in float64 on the CPU's sequential sums the two formulations agree to
round-off.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, constants
from ._dispatch import check_operands

#: launches since the count was last reset
LAUNCHES = {"sim1": 0}

_FN = {torch.float32: "pace_sim1_f32", torch.float64: "pace_sim1_f64"}


def _fn(dtype):
    fn = getattr(_build.library("sim1"), _FN[dtype])
    if fn.argtypes is None:
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [P, P, P, P, P, P, D, D, D, D, D, D, P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def sim1_solver_cuda(w, delz, pt, delp, pkz, ws, dt: float, ptop: float = 0.0,
                     p_fac: float = 0.0):
    """Column-kernel ``(w_new, delz_new (S, K, Y, X), pp (S, K+1, Y, X))`` of
    CUDA layer fields ``w, delz, pt, delp, pkz (S, K, Y, X)`` and the surface
    velocity ``ws (S, Y, X)``; ``p_fac <= 0`` skips the pressure floor."""
    if w.ndim != 4:
        raise ValueError(f"sim1 kernel takes (S, K, Y, X) fields, got {tuple(w.shape)}")
    S, K, Y, X = w.shape
    if K < 2:
        raise ValueError("sim1 kernel needs at least two layers")
    check_operands(
        "sim1 kernel",
        [(n, t, (S, K, Y, X)) for n, t in
         (("w", w), ("delz", delz), ("pt", pt), ("delp", delp), ("pkz", pkz))]
        + [("ws", ws, (S, Y, X))],
        w,
    )
    w_new = torch.empty_like(w)
    delz_new = torch.empty_like(w)
    pp = torch.empty((S, K + 1, Y, X), dtype=w.dtype, device=w.device)
    rc = _fn(w.dtype)(
        w.data_ptr(), delz.data_ptr(), pt.data_ptr(), delp.data_ptr(), pkz.data_ptr(),
        ws.data_ptr(), float(dt), float(ptop), float(p_fac), constants.GRAV, constants.RDGAS,
        1.0 / (1.0 - constants.KAPPA), w_new.data_ptr(), delz_new.data_ptr(), pp.data_ptr(),
        S, K, Y * X, _build.stream_handle(w.device),
    )
    _build.check(rc, "sim1 kernel")
    LAUNCHES["sim1"] += 1
    return w_new, delz_new, pp
