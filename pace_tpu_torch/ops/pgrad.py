"""Hydrostatic interface quantities and the C-grid pressure-gradient force.

Port of the C-grid part of ``pace_tpu.ops.pgrad`` (reference roles:
``pyFV3.stencils.pe_halo`` / ``pk3_halo`` and the hydrostatic gz integral
inside dyn_core; the C-grid pressure gradient ``p_grad_c``).
:func:`hydrostatic_interfaces` is the plain PyTorch version of the column
chain; ``ops/hydro_kernel.py`` holds its CUDA kernel and the dispatching
``hydrostatic_interfaces_best``.
"""

from __future__ import annotations

import torch

from .. import constants
from .stencil_utils import (
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)


def hydrostatic_interfaces(delp, pt, phis, ptop: float):
    """Interface pressures and geopotential from layer thickness/temperature.

    Computed over the FULL padded domain (halo columns included — delp's
    halo is valid after exchange), so the halo ring of pe/pk comes out
    identical by construction and no edge-fill pass is needed.

    Returns (pe, peln, pk, pkz, gz):
      pe   (.., K+1, Y, X) interface pressure [Pa], pe[0] = ptop
      peln log(pe)
      pk   (pe / P_REF)^kappa
      pkz  layer-mean pk (exact integral: d(pk)/(kappa d(ln p)))
      gz   interface geopotential [m^2/s^2], gz[K] = phis
    """
    kap = constants.KAPPA
    pe_below = ptop + torch.cumsum(delp, dim=-3)
    top = torch.full_like(pe_below[..., :1, :, :], ptop)
    pe = torch.cat([top, pe_below], dim=-3)
    peln = torch.log(pe)
    pk = (pe / constants.P_REF) ** kap
    dpk = pk[..., 1:, :, :] - pk[..., :-1, :, :]
    pkz = dpk / (kap * (peln[..., 1:, :, :] - peln[..., :-1, :, :]))
    # gz upward accumulation: gz[k] = phis + cp * sum_{m>=k} pt[m] * dpk[m]
    contrib = constants.CP_AIR * pt * dpk  # (.., K, Y, X)
    csum = torch.flip(torch.cumsum(torch.flip(contrib, dims=(-3,)), dim=-3), dims=(-3,))
    phis_e = phis.unsqueeze(-3) if phis.ndim < contrib.ndim else phis
    gz_top = phis_e + csum
    gz_sfc = phis_e * torch.ones_like(contrib[..., :1, :, :])
    gz = torch.cat([gz_top, gz_sfc], dim=-3)
    return pe, peln, pk, pkz, gz


def _pgf_pair(gz1, gz2, pk1, pk2, dt: float, rdl):
    """du = contour integral PGF between two interface-columns (K+1 arrays)."""
    wk1 = pk1[..., 1:, :, :] - pk1[..., :-1, :, :]
    wk2 = pk2[..., 1:, :, :] - pk2[..., :-1, :, :]
    g1k, g1kp = gz1[..., :-1, :, :], gz1[..., 1:, :, :]
    g2k, g2kp = gz2[..., :-1, :, :], gz2[..., 1:, :, :]
    p1k, p1kp = pk1[..., :-1, :, :], pk1[..., 1:, :, :]
    p2k, p2kp = pk2[..., :-1, :, :], pk2[..., 1:, :, :]
    term = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k)
    return dt * rdl * term / (wk1 + wk2)


def p_grad_c(uc, vc, pkc, gz, grid, dt2: float):
    """C-grid pressure-gradient update from cell-center interface columns
    ``pkc``, ``gz`` ``(.., K+1, Y, X)``; ``pkc`` is ``pk`` in the hydrostatic
    case and the full pressure in the nonhydrostatic one."""
    du = _pgf_pair(
        x_cell_to_left_iface(gz),
        x_cell_to_right_iface(gz),
        x_cell_to_left_iface(pkc),
        x_cell_to_right_iface(pkc),
        dt2,
        bcast_k(grid.rdxc, uc),
    )
    dv = _pgf_pair(
        y_cell_to_left_iface(gz),
        y_cell_to_right_iface(gz),
        y_cell_to_left_iface(pkc),
        y_cell_to_right_iface(pkc),
        dt2,
        bcast_k(grid.rdyc, vc),
    )
    return uc + du, vc + dv
