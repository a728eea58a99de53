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

:func:`fvtp2d` is the plain PyTorch formulation; :func:`fvtp2d_multi`
(several fields sharing the winds) and :func:`fvtp2d_tracer` (a stacked
tracer block) apply it one field at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ppm
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


def fvtp2d_multi(fields, crx, cry, xfx, yfx, area, mfx=None, mfy=None):
    """Transport several fields that share the winds and fluxes.

    ``fields``: sequence of ``(qx, qy, hord, use_mf)``; a field with
    ``use_mf`` weights its interface values by ``mfx``/``mfy``, the others
    by ``xfx``/``yfx``. Returns a list of :class:`Fluxes2D` in field order,
    each the single-field :func:`fvtp2d` call's.
    """
    return [fvtp2d(qx, qy, crx, cry, xfx, yfx, area, hord,
                   mfx=mfx if use_mf else None, mfy=mfy if use_mf else None)
            for qx, qy, hord, use_mf in fields]


def fvtp2d_tracer(qx, qy, crx, cry, xfx, yfx, area, mfx, mfy, hord: int):
    """Mass-flux-weighted fluxes ``(fx, fy)`` of a tracer block ``(S, nq, K,
    Y, X)``; ``qy`` a full block or a CornerPatch ``(S, nq, K, 2h, 2h)``. One
    tracer at a time (the formulation's intermediates exist for one tracer
    only)."""
    from .folds import CornerPatch

    fxs, fys = [], []
    for t in range(qx.shape[1]):
        qy_t = CornerPatch(qy.data[:, t]) if isinstance(qy, CornerPatch) else qy[:, t]
        fl = fvtp2d(qx[:, t], qy_t, crx, cry, xfx, yfx, area, hord, mfx=mfx, mfy=mfy)
        fxs.append(fl.fx)
        fys.append(fl.fy)
    return torch.stack(fxs, dim=1), torch.stack(fys, dim=1)


def flux_divergence(fx, fy, rarea):
    """Per-cell tendency sum of face fluxes: (in - out) * 1/area."""
    return (x_iface_diff(fx) + y_iface_diff(fy)) * bcast_k(rarea, fx[..., :-1])
