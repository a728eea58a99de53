"""The hydrostatic column-chain CUDA kernel's wrapper.

Kernel source: ``csrc/hydro.cu`` (replaces ``pace_tpu/ops/hydro_pallas.py``
``_kernel``). :func:`hydrostatic_interfaces_cuda` computes only the outputs
named in ``need`` and counts its launches in :data:`LAUNCHES`;
:func:`hydrostatic_interfaces_best` picks it or the plain version
(``ops.pgrad.hydrostatic_interfaces``) by where its operands lie
(ops/_dispatch.py).

The kernel sums sequentially in k. In float32 a parallel cumulative sum
rounds differently, so ``pe`` and ``gz`` agree with the plain version on the
card to about K ulps of the column maximum; ``pkz`` amplifies an ulp of
``pk`` or ``peln`` by ``pk/dpk`` or ``peln/dpeln``. In float64 on the CPU's
sequential sums the two agree to round-off.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, constants
from ._dispatch import check_operands, route
from .pgrad import hydrostatic_interfaces

#: launches since the count was last reset
LAUNCHES = {"hydro": 0}

_ALL = ("pe", "peln", "pk", "pkz", "gz")
_FN = {torch.float32: "pace_hydro_f32", torch.float64: "pace_hydro_f64"}


def _fn(dtype):
    fn = getattr(_build.library("hydro"), _FN[dtype])
    if fn.argtypes is None:
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [P, P, P, D, D, D, D, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return fn


def _needed(need):
    unknown = set(need) - set(_ALL)
    if unknown:
        raise ValueError(f"unknown hydrostatic outputs {sorted(unknown)}; choose from {_ALL}")
    return tuple(n for n in _ALL if n in need)


def hydrostatic_interfaces_cuda(delp, pt, phis, ptop: float, need=("pk", "pkz", "gz")):
    """Column-kernel ``(pe, peln, pk, pkz, gz)`` of CUDA ``delp, pt (S, K, Y,
    X)`` and ``phis (S, Y, X)``, with ``None`` for outputs not in ``need``."""
    need = _needed(need)
    if delp.ndim != 4:
        raise ValueError(f"hydro kernel takes (S, K, Y, X) fields, got {tuple(delp.shape)}")
    S, K, Y, X = delp.shape
    check_operands(
        "hydro kernel",
        [("delp", delp, (S, K, Y, X)), ("pt", pt, (S, K, Y, X)), ("phis", phis, (S, Y, X))],
        delp,
    )
    outs = {
        n: torch.empty((S, K if n == "pkz" else K + 1, Y, X), dtype=delp.dtype,
                       device=delp.device)
        for n in need
    }
    ptr = lambda n: outs[n].data_ptr() if n in outs else None  # noqa: E731
    rc = _fn(delp.dtype)(
        delp.data_ptr(), pt.data_ptr(), phis.data_ptr(), float(ptop),
        constants.P_REF, constants.KAPPA, constants.CP_AIR,
        *(ptr(n) for n in _ALL), S, K, Y * X, _build.stream_handle(delp.device),
    )
    _build.check(rc, "hydro kernel")
    LAUNCHES["hydro"] += 1
    return tuple(outs.get(n) for n in _ALL)


def hydrostatic_interfaces_best(delp, pt, phis, ptop: float, need):
    """Hydrostatic interface chain: the column kernel for CUDA tensors
    (``need``-pruned outputs), the plain version for CPU tensors. Returns
    (pe, peln, pk, pkz, gz) with ``None`` for entries outside ``need``."""
    need = _needed(need)
    if route(delp, pt, phis) == "kernel":
        return hydrostatic_interfaces_cuda(delp, pt, phis, ptop, need)
    res = dict(zip(_ALL, hydrostatic_interfaces(delp, pt, phis, ptop)))
    return tuple(res[n] if n in need else None for n in _ALL)
