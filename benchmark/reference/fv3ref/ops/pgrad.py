"""Hydrostatic interface quantities and the pressure-gradient force.

Port of ``pace_tpu.ops.pgrad`` (reference roles: ``pyFV3.stencils.pe_halo``
/ ``pk3_halo`` and the hydrostatic gz integral inside dyn_core; the C-grid
pressure gradient ``p_grad_c``; the A-grid to B-grid interpolation
``a2b_ord4`` and the hydrostatic D-grid pressure gradient ``one_grad_p``).
:func:`hydrostatic_interfaces` is the plain PyTorch version of the column
chain. The nonhydrostatic D-grid pressure gradient is
``ops.nonhydro.nh_p_grad``.
"""

from __future__ import annotations

import weakref

import torch

from .. import constants
from .corners import extrapolate_3_to_corner
from .d2a2c import centers_to_x_ifaces, centers_to_y_ifaces
from .stencil_utils import (
    bcast_k,
    sx,
    sy,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)


def a2b_ord4(q, grid=None):
    """4th-order A-grid (cell centers) -> B-grid (corners) interpolation,
    ``(.., Y, X) -> (.., Y+1, X+1)``.

    Uniform separable 4th-order weights in the interior. On tile-edge
    interface lines the two adjacent cell centers straddle the coordinate
    kink, so the across-edge value is the great-circle-distance-weighted
    2-point interpolation (``grid.a2b_*`` weights) of the inside center and
    the ghost center interpolated along the edge; the first interior
    interface next to an edge takes the one-sided cubic of the 4 inside
    centers; on the S/N edge rows the value is then the 4th-order
    interpolation along the edge. Each correction is a blend ``x + e (y -
    x)`` with the 0/1 edge flags, as in ``pace_tpu``. At 3-valent cube
    corners the value is the mean of the 3 one-sided diagonal
    extrapolations. Without a grid only the interior formula is applied.
    """
    qx = centers_to_x_ifaces(q)
    if grid is not None:
        # W/E tile-edge columns: along-edge-corrected ghost + across average
        q_l = x_cell_to_left_iface(q)
        q_r = x_cell_to_right_iface(q)
        gl = bcast_k(grid.a2b_ghost_left_x, qx)
        ghost = gl * q_l + (1.0 - gl) * q_r
        inside = gl * q_r + (1.0 - gl) * q_l
        ghost_t = (
            bcast_k(grid.a2b_x_w0, qx) * ghost
            + bcast_k(grid.a2b_x_wp, qx) * torch.roll(ghost, -1, dims=-2)
            + bcast_k(grid.a2b_x_wm, qx) * torch.roll(ghost, 1, dims=-2)
        )
        qmx = 0.5 * (inside + ghost_t)
        ex = bcast_k(grid.edge_w_iface + grid.edge_e_iface, qx)
        qx = qx + ex * (qmx - qx)
        # first interior interface next to the edge: the one-sided cubic of
        # the 4 inside centers (5/16, 15/16, -5/16, 1/16)
        os_r = (
            0.3125 * q_l + 0.9375 * q_r
            - 0.3125 * x_cell_to_right_iface(sx(q, 1))
            + 0.0625 * x_cell_to_right_iface(sx(q, 2))
        )
        os_l = (
            0.3125 * q_r + 0.9375 * q_l
            - 0.3125 * x_cell_to_left_iface(sx(q, -1))
            + 0.0625 * x_cell_to_left_iface(sx(q, -2))
        )
        in_w = bcast_k(torch.roll(grid.edge_w_iface, 1, dims=-1), qx)
        in_e = bcast_k(torch.roll(grid.edge_e_iface, -1, dims=-1), qx)
        qx = qx + in_w * (os_r - qx) + in_e * (os_l - qx)
    out = centers_to_y_ifaces(qx)
    if grid is not None:
        # S/N tile-edge rows: same treatment, then 4th-order along the edge
        qy = centers_to_y_ifaces(q)
        q_s = y_cell_to_left_iface(q)
        q_n = y_cell_to_right_iface(q)
        gs = bcast_k(grid.a2b_ghost_south_y, qy)
        ghost = gs * q_s + (1.0 - gs) * q_n
        inside = gs * q_n + (1.0 - gs) * q_s
        ghost_t = (
            bcast_k(grid.a2b_y_w0, qy) * ghost
            + bcast_k(grid.a2b_y_wp, qy) * torch.roll(ghost, -1, dims=-1)
            + bcast_k(grid.a2b_y_wm, qy) * torch.roll(ghost, 1, dims=-1)
        )
        qmy = 0.5 * (inside + ghost_t)
        ey_line = bcast_k(grid.edge_s_iface + grid.edge_n_iface, qy)
        qy = qy + ey_line * (qmy - qy)
        os_n = (
            0.3125 * q_s + 0.9375 * q_n
            - 0.3125 * y_cell_to_right_iface(sy(q, 1))
            + 0.0625 * y_cell_to_right_iface(sy(q, 2))
        )
        os_s = (
            0.3125 * q_n + 0.9375 * q_s
            - 0.3125 * y_cell_to_left_iface(sy(q, -1))
            + 0.0625 * y_cell_to_left_iface(sy(q, -2))
        )
        in_s = bcast_k(torch.roll(grid.edge_s_iface, 1, dims=-2), qy)
        in_n = bcast_k(torch.roll(grid.edge_n_iface, -1, dims=-2), qy)
        qy = qy + in_s * (os_n - qy) + in_n * (os_s - qy)
        out_y = centers_to_x_ifaces(qy)
        ey = bcast_k(grid.edge_s_iface + grid.edge_n_iface, out)
        out = out + ey * (out_y - out)
        out = extrapolate_3_to_corner(q, grid, out)
    return out


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


_A2B_FACTORY = None
#: (weak reference to a grid, that grid's a2b FrozenStencil)
_A2B_STENCIL = None


def _a2b_factory():
    """The module's ``StencilFactory``, built once (a driver's factory lives
    as long as the driver)."""
    global _A2B_FACTORY
    if _A2B_FACTORY is None:
        from ..dsl import StencilFactory

        _A2B_FACTORY = StencilFactory()
    return _A2B_FACTORY


def _a2b_stencil(grid):
    """``a2b_ord4`` on ``grid`` as one ``FrozenStencil`` from the factory,
    built at the first call with that grid (a driver steps one grid). Its
    window is the whole padded plane: this op computes ghost values that the
    next exchange overwrites."""
    global _A2B_STENCIL
    if _A2B_STENCIL is None or _A2B_STENCIL[0]() is not grid:
        ref = weakref.ref(grid)
        _A2B_STENCIL = (ref, _a2b_factory().from_origin_domain(
            lambda out, q: a2b_ord4(q, ref()), origin=(0, 0), domain=(-1, -1)))
    return _A2B_STENCIL[1]


def one_grad_p(u, v, pk, gz, grid, dt: float):
    """Hydrostatic D-grid pressure-gradient update: ``pk`` and ``gz``
    ``(.., K+1, Y, X)`` interpolated to corners by :func:`a2b_ord4`, then the
    contour PGF along each D-grid edge. Returns ``(u + du, v + dv)``.

    The two corner interpolations run through one ``dsl.FrozenStencil``, as
    ``pace_tpu``'s do. Over a whole-plane window its result is
    :func:`a2b_ord4`'s, with no copy: the output argument only gives the
    shape, a one-element tensor expanded to it."""
    a2b = _a2b_stencil(grid)
    out = pk.new_empty(()).expand(pk.shape[:-2] + (pk.shape[-2] + 1, pk.shape[-1] + 1))
    pk_b = a2b(out, pk)  # (.., K+1, Y+1, X+1)
    gz_b = a2b(out, gz)
    du = _pgf_pair(
        gz_b[..., :, :-1], gz_b[..., :, 1:], pk_b[..., :, :-1], pk_b[..., :, 1:],
        dt, bcast_k(grid.rdx, u),
    )
    dv = _pgf_pair(
        gz_b[..., :-1, :], gz_b[..., 1:, :], pk_b[..., :-1, :], pk_b[..., 1:, :],
        dt, bcast_k(grid.rdy, v),
    )
    return u + du, v + dv
