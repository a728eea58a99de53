"""C-grid shallow-water half step.

Port of ``pace_tpu.ops.c_sw`` (reference role:
``pyFV3.stencils.c_sw.CGridShallowWaterDynamics``: divergence, vorticity,
ke, delp/pt advection on the C grid). Provides the time-centered C-grid
winds and provisional (delpc, ptc) that the acoustic step's pressure-gradient
and D-grid solver consume.

Discretization (vector-invariant form, covariant components):

    d(u_cov)/dt =  (zeta + f) * vt * sina  -  d(K)/ds_x
    d(v_cov)/dt = -(zeta + f) * ut * sina  -  d(K)/ds_y

- Absolute vorticity lives at corners, from the circulation of the C-grid
  covariant winds around the dual cell (centers quadrilateral) divided by the
  dual area ``area_c``.
- K = 1/2 (ua*uc_up + va*vc_up) at centers: contravariant A-grid winds times
  upwinded covariant C-grid face values (energy-consistent pairing).
- delp/pt advance dt/2 with first-order upwind fluxes of the contravariant
  C-grid winds (provisional state only).

:func:`c_sw_tail_plain` is the plain PyTorch version of everything after
d2a2c and its halo exchanges; :func:`c_sw_tail` sends CUDA tensors to the
fused kernel (``ops/c_sw_tail_kernel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ._dispatch import route
from .corners import average_3_quadrants, dedup_corner_divergence
from .d2a2c import d2a2c_vect
from .fxadv import contravariant_ut, contravariant_vt
from .stencil_utils import (
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    x_iface_diff,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
    y_iface_diff,
)


@dataclasses.dataclass(frozen=True)
class CGridState:
    delpc: torch.Tensor
    ptc: torch.Tensor
    uc: torch.Tensor  # advanced covariant C-grid winds (pre pressure-gradient)
    vc: torch.Tensor
    ut: torch.Tensor  # contravariant C-grid winds of the INPUT state
    vt: torch.Tensor
    ua: torch.Tensor
    va: torch.Tensor
    divg_d: torch.Tensor  # corner divergence of the D-grid winds (for damping)
    #: time-integrated upwind area fluxes of ut/vt over dt2 (reused by
    #: updatedz_c so the sin_sg upwind factors are not recomputed there)
    xfx: Optional[torch.Tensor] = None
    yfx: Optional[torch.Tensor] = None


def corner_vorticity(uc, vc, grid, absolute: bool = True):
    """Vorticity at corners from the dual-cell circulation of C-grid winds."""
    ucdx = uc * bcast_k(grid.dxc, uc)  # (.., Y, X+1)
    vcdy = vc * bcast_k(grid.dyc, vc)  # (.., Y+1, X)
    circ = (
        y_cell_to_left_iface(ucdx)  # uc(jj-1, ii): bottom dual edge, +x
        - y_cell_to_right_iface(ucdx)  # uc(jj, ii): top, -x
        + x_cell_to_right_iface(vcdy)  # vc(jj, ii): right, +y
        - x_cell_to_left_iface(vcdy)  # vc(jj, ii-1): left, -y
    )
    vort = circ * bcast_k(grid.rarea_c, circ)
    if absolute:
        vort = vort + bcast_k(grid.fC, vort)
    return vort


def divergence_edge_weights(grid):
    """(uedge_w, vedge_w, edge_y, edge_x): the one-sided tile-edge form of
    the corner-divergence legs — ``u * uedge_w`` where ``edge_y > 0``
    (rows on a tile's S/N edge), ``v * vedge_w`` where ``edge_x > 0``."""
    sin_u_edge = 0.5 * (
        y_cell_to_left_iface(grid.sin_sg_n) + y_cell_to_right_iface(grid.sin_sg_s)
    )
    edge_y = torch.clamp(grid.edge_s_iface + grid.edge_n_iface, 0.0, 1.0)
    sin_v_edge = 0.5 * (
        x_cell_to_left_iface(grid.sin_sg_e) + x_cell_to_right_iface(grid.sin_sg_w)
    )
    edge_x = torch.clamp(grid.edge_w_iface + grid.edge_e_iface, 0.0, 1.0)
    return sin_u_edge * grid.dyc, sin_v_edge * grid.dxc, edge_y, edge_x


def divergence_corner(u, v, va_x, ua_y, grid, dedup: bool = True):
    """Corner divergence of the D-grid winds (reference ``divergence_corner``).

    Net outflow through the dual cell around each corner: the D-grid wind on
    each primal edge is converted to the normal component via the local angle
    (contravariant projection) and multiplied by the dual edge length.

    ``va_x``/``ua_y`` are the contravariant A-grid winds with corner ghosts in
    the x / y fold respectively — the fold each leg's cross-term average needs
    near cube corners (exchange them with halo.update_vector kind="agrid").

    ``dedup``: at 3-valent cube corners two of the four legs cross the SAME
    physical face; keep their average, not their sum. A caller that
    overwrites the cube-corner points anyway may pass ``False``.
    """
    # contravariant u~ = u_cov - v~ cos(theta); normal component = u~ sin(theta).
    # uf (at y-interface u points) is the +x normal flux through the dual edge
    # crossing that u point; vf (at x-interface v points) the +y normal flux.
    # On tile-edge rows/cols the cross-term average would read A-grid ghost
    # winds expressed in the NEIGHBOR tile's frame (broken by the coordinate
    # kink), so the cosa term is dropped there and the one-sided supergrid
    # sines are used: uf_edge = u*dyc*(sin_sg_n(j-1)+sin_sg_s(j))/2. Without
    # this the del-n divergence damping is anti-dissipative at tile edges.
    uedge_w, vedge_w, edge_y, edge_x = divergence_edge_weights(grid)
    va_c = 0.5 * (y_cell_to_left_iface(va_x) + y_cell_to_right_iface(va_x))
    uf = (
        (u - va_c * bcast_k(grid.cosa_v, u))
        * bcast_k(grid.sina_v, u)
        * bcast_k(grid.dyc, u)
    )  # (.., Y+1, X)
    uf = torch.where(bcast_k(edge_y, uf) > 0.0, u * bcast_k(uedge_w, u), uf)
    ua_c = 0.5 * (x_cell_to_left_iface(ua_y) + x_cell_to_right_iface(ua_y))
    vf = (
        (v - ua_c * bcast_k(grid.cosa_u, v))
        * bcast_k(grid.sina_u, v)
        * bcast_k(grid.dxc, v)
    )  # (.., Y, X+1)
    vf = torch.where(bcast_k(edge_x, vf) > 0.0, v * bcast_k(vedge_w, v), vf)
    # Outflow around corner (jj, ii):
    #   + uf(jj, ii) [right: dual edge through u(jj, ii)]  - uf(jj, ii-1)
    #   + vf(jj, ii) [top: through v(jj, ii)]              - vf(jj-1, ii)
    out = (x_cell_to_right_iface(uf) - x_cell_to_left_iface(uf)) + (
        y_cell_to_right_iface(vf) - y_cell_to_left_iface(vf)
    )
    if dedup:
        out = dedup_corner_divergence(uf, vf, grid, out)
    return out * bcast_k(grid.rarea_c, out)


def c_grid_area_fluxes(ut, vt, grid, dt2: float):
    """Time-integrated upwind area fluxes of the contravariant C-grid winds
    [m^2] — shared by the provisional delp/pt transport and updatedz_c."""
    xfx = (
        dt2
        * ut
        * bcast_k(grid.dy, ut)
        * torch.where(
            ut > 0.0,
            bcast_k(x_cell_to_left_iface(grid.sin_sg_e), ut),
            bcast_k(x_cell_to_right_iface(grid.sin_sg_w), ut),
        )
    )
    yfx = (
        dt2
        * vt
        * bcast_k(grid.dx, vt)
        * torch.where(
            vt > 0.0,
            bcast_k(y_cell_to_left_iface(grid.sin_sg_n), vt),
            bcast_k(y_cell_to_right_iface(grid.sin_sg_s), vt),
        )
    )
    return xfx, yfx


def c_sw_tail_plain(u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y,
                    ua, va, va_x, ua_y, grid, dt2: float, dedup: bool = True):
    """The C-grid half step after d2a2c + halo exchanges, in plain PyTorch:
    contravariant winds, provisional upwind delp/pt transport, KE/vorticity
    momentum update, corner divergence (pre-exchange). Returns (delpc, ptc,
    uc_new, vc_new, ut, vt, xfx, yfx, divg_d).

    ``dedup=False`` skips ``dedup_corner_divergence`` as the fused kernels
    do: its cube-corner writes are overwritten by the 3-quadrant average at
    the same points, so the result is the same."""
    ut = contravariant_ut(uc_x, vc_x, grid)
    vt = contravariant_vt(uc_y, vc_y, grid)

    # --- provisional delp/pt: first-order upwind transport over dt2
    xfx, yfx = c_grid_area_fluxes(ut, vt, grid, dt2)
    dp_x = torch.where(xfx > 0.0, x_cell_to_left_iface(delp), x_cell_to_right_iface(delp))
    pt_x = torch.where(xfx > 0.0, x_cell_to_left_iface(pt), x_cell_to_right_iface(pt))
    dp_y = torch.where(yfx > 0.0, y_cell_to_left_iface(delp), y_cell_to_right_iface(delp))
    pt_y = torch.where(yfx > 0.0, y_cell_to_left_iface(pt), y_cell_to_right_iface(pt))
    fx1 = dp_x * xfx
    fy1 = dp_y * yfx
    rarea = bcast_k(grid.rarea, delp)
    delpc = delp + (x_iface_diff(fx1) + y_iface_diff(fy1)) * rarea
    ptc = (
        pt * delp + (x_iface_diff(pt_x * fx1) + y_iface_diff(pt_y * fy1)) * rarea
    ) / delpc

    # --- kinetic energy at centers (contravariant . upwinded covariant)
    uc_up = torch.where(ua > 0.0, uc[..., :-1], uc[..., 1:])
    vc_up = torch.where(va > 0.0, vc[..., :-1, :], vc[..., 1:, :])
    ke = 0.5 * (ua * uc_up + va * vc_up)

    # --- absolute vorticity at corners, from the INPUT C-grid winds
    vort = corner_vorticity(uc, vc, grid, absolute=True)

    # --- momentum update (no pressure gradient here; see p_grad_c)
    # uc point (jj, ii): transverse contravariant wind from the 4 vt neighbors
    vt_cell = vt[..., :-1, :] + vt[..., 1:, :]
    vt4 = 0.25 * (x_cell_to_left_iface(vt_cell) + x_cell_to_right_iface(vt_cell))
    v_n = vt4 * bcast_k(grid.sina_u, vt4)
    zeta_u = torch.where(v_n > 0.0, vort[..., :-1, :], vort[..., 1:, :])
    ke_gx = (x_cell_to_left_iface(ke) - x_cell_to_right_iface(ke)) * bcast_k(grid.rdxc, uc)
    uc_new = uc + dt2 * (zeta_u * v_n + ke_gx)

    ut_cell = ut[..., :-1] + ut[..., 1:]
    ut4 = 0.25 * (y_cell_to_left_iface(ut_cell) + y_cell_to_right_iface(ut_cell))
    u_n = ut4 * bcast_k(grid.sina_v, ut4)
    zeta_v = torch.where(u_n > 0.0, vort[..., :-1], vort[..., 1:])
    ke_gy = (y_cell_to_left_iface(ke) - y_cell_to_right_iface(ke)) * bcast_k(grid.rdyc, vc)
    vc_new = vc + dt2 * (-zeta_v * u_n + ke_gy)

    # Corner divergence for damping. At cube corners the dual-cell formula is
    # replaced by the mean CELL divergence of the 3 real quadrants (computed
    # from the same contravariant face fluxes as the delp transport).
    divg_d = divergence_corner(u, v, va_x, ua_y, grid, dedup=dedup)
    cell_div = -(x_iface_diff(xfx) + y_iface_diff(yfx)) * rarea / dt2
    divg_d = average_3_quadrants(cell_div, grid, divg_d)
    return delpc, ptc, uc_new, vc_new, ut, vt, xfx, yfx, divg_d


def c_sw_tail(u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y,
              ua, va, va_x, ua_y, grid, dt2: float):
    """The tail: the fused CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fields = (u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y, ua, va, va_x, ua_y)
    if route(*fields, grid.rarea) == "kernel":
        from .c_sw_tail_kernel import c_sw_tail_cuda

        return c_sw_tail_cuda(*fields, grid, dt2)
    return c_sw_tail_plain(*fields, grid, dt2)


def c_sw(u, v, delp, pt, grid, halo, dt2: float) -> CGridState:
    """One C-grid half step. Inputs carry fresh halos (depth >= 3).

    ``u`` should carry y-fold corner ghosts and ``v`` x-fold (each is swept
    along its own interface axis). Derived winds (ua/va, uc/vc) are
    halo-exchanged so their corner-region ghosts are exact in the fold each
    consumer needs.
    """
    ua, va, uc, vc, _ut, _vt = d2a2c_vect(u, v, grid)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    uc_x, vc_x = halo.update_vector(uc, vc, kind="cgrid", fold="x")
    uc_y, vc_y = halo.update_vector(uc, vc, kind="cgrid", fold="y")
    # only the consumed folds (the tail reads va_x and ua_y; ua_x/va_y
    # have no consumer)
    ua_y, va_x = halo.update_vector_fold_pair(ua, va, kind="agrid")

    delpc, ptc, uc_new, vc_new, ut, vt, xfx, yfx, divg_d = c_sw_tail(
        u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y, ua, va, va_x, ua_y, grid, dt2
    )
    # halo-exchange the corner divergence so downstream Laplacian
    # iterations see exact owner values in all ghost slots
    divg_d = halo.update_scalar(divg_d, stagger="corner", fold="x")

    return CGridState(
        delpc=delpc, ptc=ptc, uc=uc_new, vc=vc_new, ut=ut, vt=vt, ua=ua, va=va,
        divg_d=divg_d, xfx=xfx, yfx=yfx,
    )
