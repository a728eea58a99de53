"""The semi-implicit vertical solve's CUDA kernel wrapper.

Kernel source: ``csrc/sim1.cu`` (replaces ``pace_tpu/ops/sim1_pallas.py``
``_sim1_kernel``). :func:`sim1_solver_cuda` is the solve of
``ops.nonhydro.sim1_solver`` with the ``p_fac`` floor of
``ops.nonhydro._p_fac_floor`` applied inside: backward Euler for ``a_imp ==
1``, the θ-blend (its own instantiation of the kernel, ``pace_sim1_blend_*``)
for any other ``a_imp``; it counts its launches in :data:`LAUNCHES`. ``ops.nonhydro.sim1_solver_best`` picks it or the plain
version by where its operands lie (ops/_dispatch.py).

A block of the kernel owns :func:`tile_columns` columns and all K levels;
only the running sum of ``delp`` and the Thomas recurrence walk k, the rest
is spread over the levels. The kernel keeps the plain version's operation
order and sums ``delp`` sequentially in k. ``pprime = p_full - p_hyd``
cancels two numbers near 1e5 Pa, so where ``log`` or the cumulative sum of
the plain version round differently on the card, ``pp`` and ``w`` differ
from it by that ulp amplified; in float64 on the CPU's sequential sums the
two formulations agree to round-off.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, constants
from ._dispatch import check_operands

#: launches since the count was last reset
LAUNCHES = {"sim1": 0}

_FN = {torch.float32: "pace_sim1_f32", torch.float64: "pace_sim1_f64"}
_FN_BLEND = {torch.float32: "pace_sim1_blend_f32", torch.float64: "pace_sim1_blend_f64"}


#: arrays of K values a column that a block keeps in shared memory (and one
#: value more, the surface velocity)
SMEM_ARRAYS = 8
#: shared memory a block may take so that four blocks share an SM (of the
#: H100's 228 KB, less the 1 KB the card reserves for each block)
SMEM_PER_BLOCK = 57_344
#: the most a single block may take
SMEM_MAX = 232_448


def tile_columns(K: int, dtype) -> int:
    """Columns of one block of the kernel: the widest of 32, 16, ..., 1
    whose ``SMEM_ARRAYS * K + 1`` values a column fit in ``SMEM_PER_BLOCK``
    bytes; one column up to ``SMEM_MAX``. Raises where even that does not
    fit. The kernel's launcher applies the same rule (``csrc/sim1.cu``
    ``tile_columns``); the wrapper calls this one to refuse what the kernel
    would refuse, with a message."""
    per_col = (SMEM_ARRAYS * K + 1) * dtype.itemsize
    tc = 32
    while tc > 1 and tc * per_col > SMEM_PER_BLOCK:
        tc //= 2
    if tc * per_col > SMEM_MAX:
        raise ValueError(f"sim1 kernel: {K} levels of {dtype} exceed a block's shared memory")
    return tc


def _fn(dtype, blend=False):
    fn = getattr(_build.library("sim1"), (_FN_BLEND if blend else _FN)[dtype])
    if fn.argtypes is None:
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [P] * 6 + [D] * (7 if blend else 6) + [P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def sim1_solver_cuda(w, delz, pt, delp, pkz, ws, dt: float, ptop: float = 0.0,
                     p_fac: float = 0.0, a_imp: float = 1.0):
    """Column-kernel ``(w_new, delz_new (S, K, Y, X), pp (S, K+1, Y, X))`` of
    CUDA layer fields ``w, delz, pt, delp, pkz (S, K, Y, X)`` and the surface
    velocity ``ws (S, Y, X)``; ``p_fac <= 0`` skips the pressure floor, and
    ``a_imp != 1`` takes the θ-blend."""
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
    tile_columns(K, w.dtype)
    w_new = torch.empty_like(w)
    delz_new = torch.empty_like(w)
    pp = torch.empty((S, K + 1, Y, X), dtype=w.dtype, device=w.device)
    blend = float(a_imp) != 1.0
    rc = _fn(w.dtype, blend)(
        w.data_ptr(), delz.data_ptr(), pt.data_ptr(), delp.data_ptr(), pkz.data_ptr(),
        ws.data_ptr(), float(dt), float(ptop), float(p_fac), constants.GRAV, constants.RDGAS,
        1.0 / (1.0 - constants.KAPPA), *((float(a_imp),) if blend else ()),
        w_new.data_ptr(), delz_new.data_ptr(), pp.data_ptr(),
        S, K, Y * X, _build.stream_handle(w.device),
    )
    _build.check(rc, "sim1 kernel")
    LAUNCHES["sim1"] += 1
    return w_new, delz_new, pp
