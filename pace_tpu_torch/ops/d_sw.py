"""D-grid shallow-water Lagrangian dynamics (the forward step of the acoustic
loop).

Port of ``pace_tpu.ops.d_sw`` (reference role:
``pyFV3.stencils.d_sw.DGridShallowWaterLagrangianDynamics``: flux-form
advection of delp/pt/w, vorticity-flux momentum update, kinetic-energy
gradient, damping).

Scheme (Lin & Rood 1997 vector-invariant, circulation form):

- Mass/heat/w advance with fvtp2d fluxes of the time-centered C-grid winds.
- On the D grid the absolute vorticity is naturally CELL-CENTERED (primal-cell
  circulation of the edge winds), so its fluxes come from the same fvtp2d
  operator and land exactly on the wind points:

      u*dx +=  (dtke_i - dtke_{i+1})  + fy_vort      (x-edge, corners i, i+1)
      v*dy +=  (dtke_j - dtke_{j+1})  - fx_vort

  with dtke = dt*KE at corners minus the divergence-damping potential.

All cross-tile-edge fluxes are synchronized to the owning tile's values, so
mass/heat/moisture/w are conserved to roundoff globally.

:func:`d_sw_tail_plain` is the plain PyTorch version of everything after the
transport fluxes and their syncs; :func:`d_sw_tail` sends CUDA tensors to the
fused kernel (``ops/d_sw_tail_kernel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ._dispatch import route
from .corners import average_3_quadrants
from .delnflux import delnflux, lap_corner
from .folds import CornerPatch
from .fvtp2d import fvtp2d_best, fvtp2d_multi_best
from .fxadv import flux_prep_x, flux_prep_y
from .stencil_utils import (
    _pad,
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    x_iface_diff,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
    y_iface_diff,
)


@dataclasses.dataclass(frozen=True)
class DSWConfig:
    """The fields and defaults of ``pace_tpu``'s ``DSWConfig`` (a subset of
    the reference DGridShallowWaterLagrangianDynamicsConfig)."""

    hord_mt: int = 6
    hord_vt: int = 6
    hord_tm: int = 6
    hord_dp: int = 6
    nord: int = 1  # divergence damping order (0=del2, 1=del4, 2=del6)
    d2_bg: float = 0.0
    d2_bg_k1: float = 0.0  # sponge del-2 coefficient, top model level
    d2_bg_k2: float = 0.0  # sponge del-2 coefficient, second level
    d4_bg: float = 0.16
    dddmp: float = 0.0  # Smagorinsky-type adaptive del-2 divergence damping
    damp_w: float = 0.0  # vertical-velocity del-n damping coefficient
    do_vort_damp: bool = False
    vtdm4: float = 0.0  # vorticity/momentum del-n damping coefficient
    d_con: float = 0.0  # fraction of damping-dissipated KE returned as heat
    #: tile-edge del-2 band: mask the high-order divergence damping off on
    #: tile-edge corner rows and substitute del-2 there (stabilizes the
    #: composite del-2^(nord+1) at d4_bg >~ 0.12, nord >= 2)
    edge_damp_band: bool = True
    #: weight the del-n damping Laplacian with the grid-generated
    #: divg_u/divg_v arrays (sina metric, one-sided supergrid sines on
    #: tile-edge lines, GridData.divg_u/divg_v) instead of the plain dyc/dx
    #: metric: an experiment switch, off in production
    lap_divg_weights: bool = False


@dataclasses.dataclass(frozen=True)
class DSWResult:
    u: torch.Tensor
    v: torch.Tensor
    w: Optional[torch.Tensor]
    delp: torch.Tensor
    pt: torch.Tensor
    # accumulated-step fluxes for tracer transport & diagnostics
    mfx: torch.Tensor
    mfy: torch.Tensor
    crx: torch.Tensor
    cry: torch.Tensor
    xfx: torch.Tensor
    yfx: torch.Tensor
    #: KE dissipated by divergence/vorticity damping this substep [J/kg],
    #: cell-centered; feeds d_con heating + the dissipation diagnostic
    heat: Optional[torch.Tensor] = None


def absolute_vorticity_centers(u, v, grid):
    """f + primal-cell circulation of the D-grid covariant winds / area."""
    udx = u * bcast_k(grid.dx, u)  # (.., Y+1, X)
    vdy = v * bcast_k(grid.dy, v)  # (.., Y, X+1)
    circ = (
        udx[..., :-1, :]  # south edge, +x
        - udx[..., 1:, :]  # north edge, -x
        + vdy[..., 1:]  # east edge, +y
        - vdy[..., :-1]  # west edge, -y
    )
    return circ * bcast_k(grid.rarea, circ) + bcast_k(grid.f0, circ)


def kinetic_energy_corners(u, v, ut, vt, grid, dt: float):
    """dt * KE at corners: 0.5 (ub*u_up + vb*v_up), contravariant B-grid wind
    times upwinded covariant edge wind (energy-consistent pairing). At the
    3-valent cube corners the B-grid averages mix chart orientations; there
    the KE is replaced by the mean cell energy of the 3 real quadrants."""
    # contravariant x-wind at corners: average ut (x-interfaces) in y
    ub = 0.5 * (y_cell_to_left_iface(ut) + y_cell_to_right_iface(ut))
    vb = 0.5 * (x_cell_to_left_iface(vt) + x_cell_to_right_iface(vt))
    # covariant u at corner (jj, ii): upwind of the two x-edges meeting there
    u_up = torch.where(ub > 0.0, x_cell_to_left_iface(u), x_cell_to_right_iface(u))
    v_up = torch.where(vb > 0.0, y_cell_to_left_iface(v), y_cell_to_right_iface(v))
    ke = 0.5 * (ub * u_up + vb * v_up)

    # cell energies for the cube-corner fix (cheap 2-pt covariant averages)
    u_cov = 0.5 * (u[..., :-1, :] + u[..., 1:, :])
    v_cov = 0.5 * (v[..., :-1] + v[..., 1:])
    rsin2 = bcast_k(grid.rsin2, u_cov)
    cosa_s = bcast_k(grid.cosa_s, u_cov)
    ua_c = (u_cov - v_cov * cosa_s) * rsin2
    va_c = (v_cov - u_cov * cosa_s) * rsin2
    e_cell = 0.5 * (ua_c * u_cov + va_c * v_cov)
    ke = average_3_quadrants(e_cell, grid, ke)
    return dt * ke


def damping_column(config: DSWConfig, K: int):
    """Per-level del-2 background coefficients as a list of ``K`` floats
    (sponge boost on the top two levels)."""
    prof = [config.d2_bg] * K
    if K >= 1:
        prof[0] = max(config.d2_bg, config.d2_bg_k1)
    if K >= 2:
        prof[1] = max(config.d2_bg, config.d2_bg_k2)
    return prof


def damping_profile(config: DSWConfig, K: int, dtype, device=None):
    """:func:`damping_column` as a ``(K, 1, 1)`` tensor."""
    return torch.tensor(damping_column(config, K), dtype=dtype, device=device)[:, None, None]


def edge_band(grid):
    """1 on the tile-edge corner rows and columns, else 0: ``(S, Y+1, X+1)``."""
    return torch.clamp(
        grid.edge_s_iface + grid.edge_n_iface + grid.edge_w_iface + grid.edge_e_iface,
        0.0, 1.0,
    )


def tracks_heat(config: DSWConfig) -> bool:
    """Whether the tail returns the dissipation estimate."""
    return config.d_con > 0.0 or config.vtdm4 > 0.0


def d_sw_tail_plain(u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy,
                    grid, dt: float, config: DSWConfig):
    """KE + divergence damping + momentum update + dissipation estimate
    (the d_sw tail after the transport-flux syncs) in plain PyTorch. Returns
    (u_new, v_new, heat) with u_new/v_new PRE interface sync. ``dvfx``/
    ``dvfy`` are the already-synced vorticity del-n damping fluxes (or
    None)."""
    # --- kinetic energy + divergence damping potential at corners
    dtke = kinetic_energy_corners(u, v, ut, vt, grid, dt)

    # del-2 background part with the sponge profile, and the
    # Smagorinsky-type adaptive part (dddmp), limited to 0.20 as in the
    # reference divergence_damping.
    K = u.shape[-3]
    d2_col = damping_profile(config, K, u.dtype, u.device)
    if config.dddmp > 0.0:
        # deformation magnitude at corners: combine corner divergence with
        # 4-point-averaged relative vorticity
        zeta = vort - bcast_k(grid.f0, vort)
        zeta_p = _pad(_pad(zeta, -2, 1, 1), -1, 1, 1)
        zeta_c = 0.25 * (
            zeta_p[..., :-1, :-1]
            + zeta_p[..., :-1, 1:]
            + zeta_p[..., 1:, :-1]
            + zeta_p[..., 1:, 1:]
        )
        smag = dt * torch.sqrt(divg_d * divg_d + zeta_c * zeta_c)
        damp2 = torch.maximum(d2_col, torch.clamp(config.dddmp * smag, max=0.20))
    else:
        damp2 = d2_col
    chi = grid.da_min_c * damp2 * divg_d
    if config.nord > 0:
        # higher-order part: overflow-safe factoring of
        # (d4_bg*da_min_c)^(nord+1): one da_min_c folded into each Laplacian
        # iteration keeps intermediates O(1) in f32 (see delnflux)
        d2 = divg_d
        for _ in range(config.nord):
            d2 = lap_corner(d2, grid, divg_weights=config.lap_divg_weights) * grid.da_min_c
        dampn = config.d4_bg ** (config.nord + 1) * grid.da_min_c
        chin = dampn * d2 * ((-1.0) ** config.nord)
        if config.edge_damp_band:
            # Tile-edge stabilization: the composite del-2^(nord+1)
            # operator's eigenvalue peaks on the tile-edge corner rows (the
            # dual areas there sit at the global minimum), tipping it into
            # an overdamping instability for d4_bg >~ 0.12 at nord=3; the
            # high-order part is masked off on the edge rows and replaced
            # by an unconditionally dissipative del-2 term.
            bandk = bcast_k(edge_band(grid), chin)
            d2_edge = max(config.d4_bg / 3.0, config.d2_bg)
            chi_edge = grid.da_min_c * d2_edge * divg_d
            chi = chi + (1.0 - bandk) * chin + bandk * chi_edge
        else:
            chi = chi + chin
    dtke = dtke - chi

    if dvfx is not None:
        vfx = vfx + dvfx
        vfy = vfy + dvfy

    # --- circulation-form momentum update
    u_new = (
        u * bcast_k(grid.dx, u) + (dtke[..., :-1] - dtke[..., 1:]) + vfy
    ) * bcast_k(grid.rdx, u)
    v_new = (
        v * bcast_k(grid.dy, v) + (dtke[..., :-1, :] - dtke[..., 1:, :]) - vfx
    ) * bcast_k(grid.rdy, v)

    # --- dissipation estimate: KE removed by the damping terms this substep
    # (drives d_con heating and the dissipation diagnostic). Trapezoidal
    # u·du using the damping-only wind increments.
    heat = None
    if tracks_heat(config):
        du_d = (chi[..., 1:] - chi[..., :-1]) * bcast_k(grid.rdx, u)
        dv_d = (chi[..., 1:, :] - chi[..., :-1, :]) * bcast_k(grid.rdy, v)
        if dvfy is not None:
            du_d = du_d + dvfy * bcast_k(grid.rdx, u)
            dv_d = dv_d - dvfx * bcast_k(grid.rdy, v)
        e_u = (u + 0.5 * du_d) * du_d  # at u points
        e_v = (v + 0.5 * dv_d) * dv_d  # at v points
        heat = -(
            0.5 * (e_u[..., :-1, :] + e_u[..., 1:, :])
            + 0.5 * (e_v[..., :-1] + e_v[..., 1:])
        )
    return u_new, v_new, heat


def d_sw_tail(u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy,
              grid, dt: float, config: DSWConfig):
    """The tail: the fused CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fields = (u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy)
    if route(*fields, grid.rarea_c) == "kernel":
        from .d_sw_tail_kernel import d_sw_tail_cuda

        return d_sw_tail_cuda(*fields, grid, dt, config)
    return d_sw_tail_plain(*fields, grid, dt, config)


def d_sw(
    u,
    v,
    w,
    delp_x,
    delp_y,
    pt_x,
    pt_y,
    w_x,
    w_y,
    uc_x,
    vc_x,
    uc_y,
    vc_y,
    divg_d,
    grid,
    halo,
    dt: float,
    config: DSWConfig,
) -> DSWResult:
    """One forward D-grid step over ``dt``.

    ``*_x``/``*_y`` are fields with corner ghosts filled in the x / y fold
    convention (identical away from tile corners; the y folds of the
    scalars may be CornerPatches). The C-grid wind pair is passed in both
    folds; x-direction transport quantities (crx, xfx) come from the x-fold
    pair, y-direction from the y-fold pair, so strip-extreme cross-term
    averages near cube corners read fold-consistent ghosts.
    """
    delp = delp_x
    pt = pt_x
    crx, xfx, ut = flux_prep_x(uc_x, vc_x, grid, dt)
    cry, yfx, vt = flux_prep_y(uc_y, vc_y, grid, dt)

    rarea = grid.rarea

    # vorticity is needed below for the momentum update; computing it here
    # lets its transport ride the same multi-field fvtp2d as pt/w. Its
    # y-fold is consumed only by the transport kernel -> corner pack, not a
    # second full tensor (see ops.folds).
    vort = absolute_vorticity_centers(u, v, grid)
    vort_x, vort_p = halo.update_scalar_fold_patch(vort)
    vort_y = CornerPatch(vort_p)

    # --- mass fluxes
    fl = fvtp2d_best(delp_x, delp_y, crx, cry, xfx, yfx, grid.area, config.hord_dp)
    mfx, mfy = halo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")

    # pt/vorticity/w share the winds and mass fluxes with the delp transport
    # above, so they go through ONE multi-field kernel that stages
    # crx/cry/xfx/yfx/area once
    trio = [
        (pt_x, pt_y, config.hord_tm, True),
        (vort_x, vort_y, config.hord_vt, False),
    ]
    if w is not None:
        trio.append((w_x, w_y, config.hord_vt, True))
    fls = fvtp2d_multi_best(trio, crx, cry, xfx, yfx, grid.area, mfx=mfx, mfy=mfy)
    fpt, fv_ = fls[0], fls[1]
    ptfx, ptfy = halo.sync_vector_interfaces(fpt.fx, fpt.fy, kind="cgrid")
    vfx, vfy = halo.sync_vector_interfaces(fv_.fx, fv_.fy, kind="cgrid")
    wfx = wfy = None
    if w is not None:
        wfx, wfy = halo.sync_vector_interfaces(fls[2].fx, fls[2].fy, kind="cgrid")

    delp_new = delp + (x_iface_diff(mfx) + y_iface_diff(mfy)) * bcast_k(rarea, delp)
    pt_new = (
        pt * delp + (x_iface_diff(ptfx) + y_iface_diff(ptfy)) * bcast_k(rarea, pt)
    ) / delp_new

    w_new = None
    if w is not None:
        if config.damp_w > 0.0:
            dfx, dfy = delnflux(w_x, grid, config.nord, config.damp_w, grid.da_min)
            wfx = wfx + dfx
            wfy = wfy + dfy
        w_new = (
            w * delp + (x_iface_diff(wfx) + y_iface_diff(wfy)) * bcast_k(rarea, w)
        ) / delp_new

    # vorticity del-n damping (reference do_vort_damp/vtdm4: delnflux on the
    # vorticity field, fluxes folded into the vorticity fluxes). Computed
    # BEFORE the fused tail so its cross-tile flux sync stays outside the
    # kernel (values are independent of the tail's inputs).
    dvfx = dvfy = None
    if config.do_vort_damp and config.vtdm4 > 0.0:
        nord_v = min(2, config.nord) if config.nord > 0 else 0
        dvfx, dvfy = delnflux(vort_x, grid, nord_v, config.vtdm4, grid.da_min)
        dvfx, dvfy = halo.sync_vector_interfaces(dvfx, dvfy, kind="cgrid")

    # --- fused tail: kinetic energy + divergence-damping potential +
    # circulation-form momentum update + dissipation estimate
    u_new, v_new, heat = d_sw_tail(
        u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy, grid, dt, config
    )
    u_new, v_new = halo.sync_vector_interfaces(u_new, v_new, kind="dgrid")

    return DSWResult(
        u=u_new, v=v_new, w=w_new, delp=delp_new, pt=pt_new, mfx=mfx, mfy=mfy,
        crx=crx, cry=cry, xfx=xfx, yfx=yfx, heat=heat,
    )
