"""Finite-volume flux preparation: C-grid winds -> courant numbers + area fluxes.

Port of ``pace_tpu.ops.fxadv`` (reference role:
``pyFV3.stencils.fxadv.FiniteVolumeFluxPrep``). ``uc`` is the covariant
C-grid x-wind at x-interfaces ``(S, K, Y, X+1)``; ``vc`` the covariant
y-wind at y-interfaces ``(S, K, Y+1, X)``. Outputs: contravariant winds
``ut``/``vt``, courant numbers ``crx``/``cry`` in cell-index units (upwind
cell metric) and swept areas ``xfx``/``yfx`` over ``dt`` [m^2]. Halo ghost
values are exact neighbor-tile values along the continued index line, so
the interior formula applies uniformly.
"""

from __future__ import annotations

import torch

from .stencil_utils import (
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)


def contravariant_ut(uc, vc, grid):
    """Contravariant x-wind at x-interfaces from covariant C-grid winds."""
    vc_cell = vc[..., :-1, :] + vc[..., 1:, :]
    vc4 = 0.25 * (x_cell_to_left_iface(vc_cell) + x_cell_to_right_iface(vc_cell))
    return (uc - bcast_k(grid.cosa_u, uc) * vc4) * bcast_k(grid.rsin_u2, uc)


def contravariant_vt(uc, vc, grid):
    """Contravariant y-wind at y-interfaces from covariant C-grid winds."""
    uc_cell = uc[..., :-1] + uc[..., 1:]
    uc4 = 0.25 * (y_cell_to_left_iface(uc_cell) + y_cell_to_right_iface(uc_cell))
    return (vc - bcast_k(grid.cosa_v, vc) * uc4) * bcast_k(grid.rsin_v2, vc)


def contravariant_c_winds(uc, vc, grid):
    """Contravariant (ut, vt) from covariant C-grid (uc, vc)."""
    return contravariant_ut(uc, vc, grid), contravariant_vt(uc, vc, grid)


def flux_prep_x(uc, vc, grid, dt: float):
    """x-direction half of flux_prep: (crx, xfx, ut)."""
    ut = contravariant_ut(uc, vc, grid)
    # upwind cell is ii-1 when ut > 0, else ii
    rdxa_l = bcast_k(x_cell_to_left_iface(grid.rdxa), ut)
    rdxa_r = bcast_k(x_cell_to_right_iface(grid.rdxa), ut)
    crx = dt * ut * torch.where(ut > 0.0, rdxa_l, rdxa_r)
    # swept area: dt * ut * face_length * sin(upwind-side grid angle)
    sin_l = bcast_k(x_cell_to_left_iface(grid.sin_sg_e), ut)
    sin_r = bcast_k(x_cell_to_right_iface(grid.sin_sg_w), ut)
    xfx = dt * ut * bcast_k(grid.dy, ut) * torch.where(ut > 0.0, sin_l, sin_r)
    return crx, xfx, ut


def flux_prep_y(uc, vc, grid, dt: float):
    """y-direction half of flux_prep: (cry, yfx, vt)."""
    vt = contravariant_vt(uc, vc, grid)
    rdya_l = bcast_k(y_cell_to_left_iface(grid.rdya), vt)
    rdya_r = bcast_k(y_cell_to_right_iface(grid.rdya), vt)
    cry = dt * vt * torch.where(vt > 0.0, rdya_l, rdya_r)
    sin_s = bcast_k(y_cell_to_left_iface(grid.sin_sg_n), vt)
    sin_n = bcast_k(y_cell_to_right_iface(grid.sin_sg_s), vt)
    yfx = dt * vt * bcast_k(grid.dx, vt) * torch.where(vt > 0.0, sin_s, sin_n)
    return cry, yfx, vt


def flux_prep(uc, vc, grid, dt: float):
    """Compute (crx, cry, xfx, yfx, ut, vt) for transport over ``dt`` seconds."""
    crx, xfx, ut = flux_prep_x(uc, vc, grid, dt)
    cry, yfx, vt = flux_prep_y(uc, vc, grid, dt)
    return crx, cry, xfx, yfx, ut, vt
