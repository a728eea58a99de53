"""2-D finite-volume transport (Lin & Rood 1996 directionally-symmetric PPM).

Port of ``pace_tpu.ops.fvtp2d`` (reference role:
``pyFV3.stencils.fvtp2d.FiniteVolumeTransport``). Scheme:

    Fx = 1/2 [ X(q) + X(Y(q)) ] * xfx
    Fy = 1/2 [ Y(q) + Y(X(q)) ] * yfx

where X/Y are 1-D PPM interface-value operators and Y(q)/X(q) denote the
flux-form inner update divided by the updated area.

Corner handling: the caller passes two corner-filled versions of q — ``qx``
with corner ghosts along continued x index lines and ``qy`` along y (a full
tensor or a :class:`~pace_tpu_torch.ops.folds.CornerPatch`). The inner
y-sweep feeding the x-flux uses ``qy`` and vice versa.

:func:`fvtp2d` is the plain PyTorch formulation; :func:`fvtp2d_best` and
:func:`fvtp2d_multi_best` (several fields sharing the winds) launch the fused
CUDA kernels for CUDA tensors (ops/fvtp2d_kernel.py).
"""

from __future__ import annotations

import dataclasses

import torch

from . import ppm
from ._dispatch import route
from .stencil_utils import bcast_k, x_iface_diff, y_iface_diff


@dataclasses.dataclass(frozen=True)
class Fluxes2D:
    fx: torch.Tensor  # (S, [K,] Y, X+1) flux through x-interfaces (+x positive)
    fy: torch.Tensor  # (S, [K,] Y+1, X)


def fvtp2d(
    qx, qy, crx, cry, xfx, yfx, area, hord: int, mfx=None, mfy=None
) -> Fluxes2D:
    """2-D PPM fluxes of a cell-mean scalar (plain PyTorch).

    ``qx``/``qy``: the field in x / y corner-fold convention ``(S, [K,] Y,
    X)`` (``qy`` may be a CornerPatch); ``crx``/``cry``: courant numbers at
    x/y interfaces; ``xfx``/``yfx``: area fluxes [m^2]; ``area``: ``(S, Y,
    X)``; ``mfx``/``mfy``: optional mass fluxes that replace ``xfx``/``yfx``
    as the weights of the returned fluxes.
    """
    from .folds import materialize_qy

    qy = materialize_qy(qx, qy)
    area_b = bcast_k(area, qx)

    fy1 = ppm.yppm_i(qy, cry, hord)  # (.., Y+1, X)
    fx1 = ppm.xppm_i(qx, crx, hord)  # (.., Y, X+1)

    # --- x-flux branch: inner y-advection of qy, then outer xppm
    ra_y = area_b + y_iface_diff(yfx)
    q_i = (qy * area_b + y_iface_diff(yfx * fy1)) / ra_y
    fx_outer = ppm.xppm_i(q_i, crx, hord)
    wx = xfx if mfx is None else mfx
    fx = 0.5 * (fx_outer + fx1) * wx

    # --- y-flux branch: inner x-advection of qx, then outer yppm
    ra_x = area_b + x_iface_diff(xfx)
    q_j = (qx * area_b + x_iface_diff(xfx * fx1)) / ra_x
    fy_outer = ppm.yppm_i(q_j, cry, hord)
    wy = yfx if mfy is None else mfy
    fy = 0.5 * (fy_outer + fy1) * wy

    return Fluxes2D(fx=fx, fy=fy)


def fvtp2d_best(
    qx, qy, crx, cry, xfx, yfx, area, hord: int, mfx=None, mfy=None
) -> Fluxes2D:
    """As :func:`fvtp2d`; CUDA tensors go through the fused kernel.

    The kernel agrees with :func:`fvtp2d` on the consumed interior; only the
    never-consumed outermost interface row/col differs (zero vs wrap-around
    values)."""
    from .folds import CornerPatch

    qy_t = qy.data if isinstance(qy, CornerPatch) else qy
    if route(qx, qy_t, crx, cry, xfx, yfx, area, mfx, mfy) == "kernel":
        from .fvtp2d_kernel import fvtp2d_cuda

        fx, fy = fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, area, hord, mfx=mfx, mfy=mfy)
        return Fluxes2D(fx=fx, fy=fy)
    return fvtp2d(qx, qy, crx, cry, xfx, yfx, area, hord, mfx=mfx, mfy=mfy)


def fvtp2d_multi_best(fields, crx, cry, xfx, yfx, area, mfx=None, mfy=None):
    """Transport several fields that share the winds and fluxes.

    ``fields``: sequence of ``(qx, qy, hord, use_mf)``; a field with
    ``use_mf`` weights its interface values by ``mfx``/``mfy``, the others
    by ``xfx``/``yfx``. CUDA tensors go through one launch of the fused
    multi-field kernel, which stages ``crx/cry/xfx/yfx/area`` once for all
    fields (d_sw's pt/vorticity/w triple); CPU tensors through the list of
    single-field :func:`fvtp2d` calls. Returns a list of :class:`Fluxes2D`
    in field order, each equal to the single-field call's.
    """
    from .folds import CornerPatch
    from .fvtp2d_kernel import fvtp2d_multi_cuda, fvtp2d_multi_plain

    tensors = [crx, cry, xfx, yfx, area, mfx, mfy]
    for qx, qy, _hord, _use_mf in fields:
        tensors += [qx, qy.data if isinstance(qy, CornerPatch) else qy]
    multi = fvtp2d_multi_cuda if route(*tensors) == "kernel" else fvtp2d_multi_plain
    outs = multi(fields, crx, cry, xfx, yfx, area, mfx=mfx, mfy=mfy)
    return [Fluxes2D(fx=fx, fy=fy) for fx, fy in outs]


def flux_divergence(fx, fy, rarea):
    """Per-cell tendency sum of face fluxes: (in - out) * 1/area."""
    return (x_iface_diff(fx) + y_iface_diff(fy)) * bcast_k(rarea, fx[..., :-1])
