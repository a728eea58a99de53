"""The vertical remap's CUDA kernel wrapper.

Kernel source: ``csrc/remap.cu`` (replaces ``pace_tpu/ops/remap_pallas.py``
``_remap_kernel``). :func:`remap_cuda` takes the operands of
``ops.remapping.remap_field`` on the card and returns its result; it counts
its launches in :data:`LAUNCHES`. ``ops.remapping.remap_field_best`` and
``remap_tracers`` pick one of the two by where the operands lie
(ops/_dispatch.py).

The pressure columns may be shared by several leading entries of ``q`` (a
tracer block): their leading dimensions equal ``q``'s up to some axis and
are 1 after it, and the kernel reads them through ``l // rep``, never
broadcast in memory. The fields that share both columns are one group: the
kernel reads the columns and finds each target interface's source cell once
for the whole group.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ._dispatch import check_operands

#: launches since the count was last reset
LAUNCHES = {"remap": 0}

#: largest displacement, in cells, between a target interface's index and
#: the source cell that holds it
D_OFFSET = 5

_FN = {torch.float32: "pace_remap_f32", torch.float64: "pace_remap_f64"}


def _fn(dtype):
    fn = getattr(_build.library("remap"), _FN[dtype])
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, I, I, I, I, I, I, P]
        fn.restype = I
    return fn


def _repeat(lead_q, lead_p, name) -> int:
    """How many leading entries of ``q`` share one pressure column."""
    if len(lead_p) != len(lead_q):
        raise ValueError(f"remap kernel: {name} has leading dims {lead_p}, q {lead_q}")
    seen_bcast = False
    for dq, dp in zip(lead_q, lead_p):
        if dp == dq and not (seen_bcast and dq != 1):
            continue
        if dp == 1:
            seen_bcast = True
            continue
        raise ValueError(f"remap kernel: {name} leading dims {lead_p} must equal q's {lead_q} "
                         "up to an axis and be 1 after it")
    return math.prod(lead_q) // math.prod(lead_p)


def remap_cuda(q, pe1, pe2, kord: int):
    """Column-kernel remap of CUDA tensors: ``q (.., K, Y, X)``, ``pe1 (..,
    K+1, Y, X)``, ``pe2 (.., K2, Y, X)``, leading dims as described above;
    returns ``(.., K2-1, Y, X)``."""
    if q.ndim < 3:
        raise ValueError(f"remap kernel takes (.., K, Y, X) fields, got {tuple(q.shape)}")
    *lead, K, Y, X = q.shape
    K2 = pe2.shape[-3]
    rep1 = _repeat(tuple(lead), tuple(pe1.shape[:-3]), "pe1")
    rep2 = _repeat(tuple(lead), tuple(pe2.shape[:-3]), "pe2")
    check_operands("remap kernel", [("q", q, q.shape),
                                    ("pe1", pe1, tuple(pe1.shape[:-3]) + (K + 1, Y, X)),
                                    ("pe2", pe2, tuple(pe2.shape[:-3]) + (K2, Y, X))], q)
    if K2 < 2:
        raise ValueError("remap kernel needs at least two target interfaces")
    out = torch.empty(tuple(lead) + (K2 - 1, Y, X), dtype=q.dtype, device=q.device)
    L = math.prod(lead)
    rc = _fn(q.dtype)(q.data_ptr(), pe1.data_ptr(), pe2.data_ptr(), out.data_ptr(), L, rep1,
                      rep2, K, K2, Y * X, int(kord), _build.stream_handle(q.device))
    _build.check(rc, "remap kernel")
    LAUNCHES["remap"] += 1
    return out
