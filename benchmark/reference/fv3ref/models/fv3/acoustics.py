"""Acoustic substep loop: the C-grid half, the D-grid half and the D-grid
pressure gradient, ``n_split`` times.

Port of ``pace_tpu.models.fv3.acoustics`` (reference role:
``pyFV3.stencils.dyn_core.AcousticDynamics``). One substep,
:func:`_one_substep`, is built from two halves. :func:`c_grid_half`: the halo
exchanges of the substep, the C-grid shallow-water half step ``c_sw``, the
hydrostatic interface chain or, in the nonhydrostatic configuration, the
interface-height update and the provisional vertical solve, and the C-grid
pressure gradient. :func:`d_grid_half`: the D-grid step ``d_sw``, the
dissipation heating, the exchange of the new ``delp, pt`` and, in the
nonhydrostatic configuration, the advection of the interface heights
(``updatedz_d``), the vertical solve (``riem_solver3``) and the halo refresh
after it. The substep then applies the D-grid pressure gradient (the fused
``nh_p_grad`` or the hydrostatic ``one_grad_p``, with beta off-centering when
``beta != 0``), the Rayleigh damping ``ray_fast`` when ``rf_fast`` and ``tau >
0``, and the final D-grid interface sync. :func:`acoustic_loop` runs
``n_split`` substeps and accumulates the transport fluxes.

Corner-fold protocol (see pace_tpu_torch.parallel.topology): every sweep
direction gets ghost data folded for that direction — u is y-swept (use
fold="y"), v is x-swept (fold="x"), each transported scalar gets both folds
(the y fold as a corner pack, see ops.folds.CornerPatch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ... import constants
from ...ops.c_sw import CGridState, c_sw
from ...ops.d_sw import DSWConfig, DSWResult, d_sw
from ...ops.dycore_extras import ray_fast
from ...ops.folds import CornerPatch
from ...ops.nonhydro import (
    heights_from_delz,
    nh_p_grad,
    riem_solver3,
    riem_solver_c,
    updatedz_c,
    updatedz_d,
)
from ...ops.pgrad import hydrostatic_interfaces, one_grad_p, p_grad_c
from ...utils.ranges import stage_range


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """Acoustic-loop parameters (the fields and defaults of ``pace_tpu``'s
    ``AcousticConfig``)."""

    n_split: int = 1
    hydrostatic: bool = True
    d_sw: DSWConfig = dataclasses.field(default_factory=DSWConfig)
    # nonhydrostatic params
    a_imp: float = 1.0
    p_fac: float = 0.05
    beta: float = 0.0
    #: cap on the per-substep dissipation-heating temperature increment,
    #: |dT| <= delt_max * dt [K]
    delt_max: float = 0.002
    #: rf_fast: apply Rayleigh damping per acoustic substep; off -> once per
    #: k_split step in the tail
    rf_fast: bool = False
    rf_cutoff: float = 750.0
    tau: float = 0.0


@dataclasses.dataclass(frozen=True)
class CGridHalf:
    """What the C-grid half of a substep hands to the D-grid half."""

    cg: CGridState
    #: C-grid winds after the pressure gradient, interface-synced, in both folds
    uc_x: torch.Tensor
    vc_x: torch.Tensor
    uc_y: torch.Tensor
    vc_y: torch.Tensor
    #: the D-grid winds in the fold each is swept in
    u_y: torch.Tensor
    v_x: torch.Tensor
    #: transported scalars: x fold, and the y fold as a corner pack
    delp_x: torch.Tensor
    delp_y: CornerPatch
    pt_x: torch.Tensor
    pt_y: CornerPatch
    #: layer-mean pk of the provisional C-grid state
    pkz_c: torch.Tensor
    w_x: Optional[torch.Tensor] = None
    w_y: Optional[CornerPatch] = None
    #: nonhydrostatic only, for the D-grid half: the exchanged ``delz``
    #: (x fold), the interface heights built from it before the advection,
    #: in both folds, and both folds of ``phis``
    delz_x: Optional[torch.Tensor] = None
    zh_x: Optional[torch.Tensor] = None
    zh_y: Optional[torch.Tensor] = None
    phis_folds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #: nonhydrostatic only: the advected interface heights, the surface
    #: velocity they imply, the solved provisional thicknesses and the full
    #: interface pressure [Pa] that ``p_grad_c`` used
    zh_c: Optional[torch.Tensor] = None
    ws_c: Optional[torch.Tensor] = None
    delz_c: Optional[torch.Tensor] = None
    pe_c: Optional[torch.Tensor] = None


def c_grid_half(u, v, w, delp, pt, delz, phis, grid, halo, config: AcousticConfig,
                dt2: float, ptop: float, phis_folds=None, checkpointer=None) -> CGridHalf:
    """The C-grid half of one acoustic substep, from the substep's halo
    exchanges to the exchanged C-grid winds the D-grid solver advects with.

    Inputs are stacked tensors (S, K, Y, X) (``u``/``v`` D-grid staggered,
    ``phis`` (S, Y, X)) on one device; ``pt`` is virtual potential
    temperature, ``dt2`` half the acoustic time step. ``w`` and ``delz`` are
    carried by the nonhydrostatic configuration only, which needs both.
    ``phis_folds`` is ``halo.update_scalar_folds(phis)``, constant over the
    substeps; it is computed here when absent. :func:`d_grid_half` takes the
    result, and :func:`_one_substep` calls both. A stage ``checkpointer``
    sees ``C_SW-In`` (``u, v, delp, pt``) and ``C_SW-Out`` (``uc, vc,
    delpc, ptc`` of ``c_sw``).
    """
    hydro = config.hydrostatic
    if not hydro and (w is None or delz is None):
        raise ValueError("nonhydrostatic mode requires w and delz")
    # the scalar exchange is started first and awaited after the vector
    # exchange, which does not depend on it
    fields = [delp, pt]
    if w is not None:
        fields.append(w)
    scalar_hdl = halo.start_update_scalars_fold_patches(fields)
    # only the consumed folds: u is y-swept, v x-swept
    u_y, v_x = halo.update_vector_fold_pair(u, v, kind="dgrid")
    # delz needs real full folds: its y fold feeds the height column sum
    delz_y = None
    if not hydro:
        delz, delz_y = halo.update_scalar_folds(delz)
    pairs = scalar_hdl.wait()
    (delp_x, delp_p), (pt_x, pt_p) = pairs[:2]
    w_x, w_y = (pairs[2][0], CornerPatch(pairs[2][1])) if w is not None else (None, None)

    # --- C-grid half step + its pressure gradient
    if checkpointer is not None:
        checkpointer("C_SW-In", u=u, v=v, delp=delp, pt=pt)
    with stage_range("C_SW"):
        cg = c_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
    if checkpointer is not None:
        checkpointer("C_SW-Out", uc=cg.uc, vc=cg.vc, delpc=cg.delpc, ptc=cg.ptc)
    nh = {}
    if hydro:
        _pe, _peln, pkc, pkz_c, gz_c = hydrostatic_interfaces(cg.delpc, cg.ptc, phis, ptop)
        uc, vc = p_grad_c(cg.uc, cg.vc, pkc, gz_c, grid, dt2)
    else:
        _pe, _peln, _pk, pkz_c, _gz = hydrostatic_interfaces(cg.delpc, cg.ptc, phis, ptop)
        # advect the interface heights with the C-grid winds that advected
        # delpc/ptc, so the provisional solve sees consistent heights and
        # the terrain-following ws they imply; each fold of delz is paired
        # with the same fold of phis
        if phis_folds is None:
            phis_folds = halo.update_scalar_folds(phis)
        phis_cx, phis_cy = phis_folds
        with stage_range("UpdateDZ"):
            zh_cx = heights_from_delz(delz, phis_cx)
            zh_cy = heights_from_delz(delz_y, phis_cy)
            zh_c, ws_c = updatedz_c(zh_cx, zh_cy, cg.xfx, cg.yfx, grid, dt2)
        delz_c = zh_c[..., 1:, :, :] - zh_c[..., :-1, :, :]
        with stage_range("RiemannC"):
            pe_full_c, delz_c_new = riem_solver_c(
                w_x, delz_c, cg.ptc, cg.delpc, pkz_c, ws_c, dt2, ptop,
                a_imp=config.a_imp, p_fac=config.p_fac,
            )
        # p_grad_c heights from the SOLVED provisional thicknesses, and the
        # contour PGF with the full pressure in Pa
        gz_c = heights_from_delz(delz_c_new, phis) * constants.GRAV
        uc, vc = p_grad_c(cg.uc, cg.vc, pe_full_c, gz_c, grid, dt2)
        nh = dict(delz_x=delz, zh_x=zh_cx, zh_y=zh_cy, phis_folds=phis_folds, zh_c=zh_c,
                  ws_c=ws_c, delz_c=delz_c_new, pe_c=pe_full_c)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    return CGridHalf(
        cg=cg, uc_x=uc_x, vc_x=vc_x, uc_y=uc_y, vc_y=vc_y, u_y=u_y, v_x=v_x,
        delp_x=delp_x, delp_y=CornerPatch(delp_p), pt_x=pt_x, pt_y=CornerPatch(pt_p),
        pkz_c=pkz_c, w_x=w_x, w_y=w_y, **nh,
    )


@dataclasses.dataclass(frozen=True)
class DGridHalf:
    """What the D-grid half of a substep, up to the vertical solve, hands to
    the D-grid pressure gradient and to the end of the substep."""

    #: ``d_sw``'s own result: ``w, delp, pt`` as transported, before the
    #: heating, the exchange and the vertical solve
    ds: DSWResult
    #: D-grid winds after ``d_sw``, before the pressure gradient
    u: torch.Tensor
    v: torch.Tensor
    #: the new ``delp, pt`` (``pt`` with the dissipation heating), exchanged
    #: in the x fold
    delp: torch.Tensor
    pt: torch.Tensor
    #: the substep's mass fluxes, Courant numbers and area fluxes, which the
    #: acoustic loop accumulates for the tracer transport
    mfx: torch.Tensor
    mfy: torch.Tensor
    crx: torch.Tensor
    cry: torch.Tensor
    xfx: torch.Tensor
    yfx: torch.Tensor
    #: KE dissipated by the damping this substep [J/kg], when tracked
    heat: Optional[torch.Tensor] = None
    #: nonhydrostatic only: ``w``, ``delz`` and the perturbation interface
    #: pressure ``pp`` [Pa] after the vertical solve, ghosts refreshed;
    #: interface ``pk`` and layer-mean ``pkz`` of the new ``delp, pt``; the
    #: interface geopotential ``gz`` [m^2/s^2] of the solved ``delz``; and the
    #: surface velocity ``ws`` [m/s] the advected heights imply
    w: Optional[torch.Tensor] = None
    delz: Optional[torch.Tensor] = None
    pp: Optional[torch.Tensor] = None
    pk: Optional[torch.Tensor] = None
    pkz: Optional[torch.Tensor] = None
    gz: Optional[torch.Tensor] = None
    ws: Optional[torch.Tensor] = None


def d_grid_half(half: CGridHalf, grid, halo, config: AcousticConfig, dt: float,
                ptop: float, phis, checkpointer=None) -> DGridHalf:
    """The D-grid half of one acoustic substep from the result of
    :func:`c_grid_half`, up to and including the vertical solve.

    ``d_sw`` advances ``u, v, delp, pt`` (and ``w``) over the full step
    ``dt`` with the exchanged C-grid winds; the dissipated kinetic energy
    heats ``pt`` (``d_con``, capped at ``delt_max * |dt|`` per substep); the
    new ``delp, pt`` are exchanged. With ``hydrostatic=False`` the interface
    heights that the C-grid half built are advected by the layer fluxes
    (``updatedz_d``), the bottom interface is pinned back to the surface
    (its displacement over ``dt`` is ``ws``), and ``riem_solver3`` solves for
    ``w``, ``delz`` and ``pp``, whose ghosts are then refreshed. With
    ``hydrostatic=True`` the function stops after the exchange and the
    vertical fields of the result are ``None``.

    ``u, v`` of the result are the winds after ``d_sw`` alone:
    :func:`_one_substep` applies the pressure gradient, ``ray_fast`` and the
    final D-grid interface sync to them. A stage ``checkpointer`` sees
    ``D_SW-Out`` (``u, v, delp, pt`` and, nonhydrostatic, ``w`` of
    ``d_sw``).
    """
    hydro = config.hydrostatic
    if not hydro and (half.w_x is None or half.zh_x is None):
        raise ValueError("nonhydrostatic mode requires the w and zh of a nonhydrostatic "
                         "C-grid half")
    cg = half.cg
    # the D-grid step takes the exchanged w for both its w arguments
    with stage_range("D_SW"):
        ds = d_sw(
            half.u_y, half.v_x, half.w_x, half.delp_x, half.delp_y, half.pt_x, half.pt_y,
            half.w_x, half.w_y, half.uc_x, half.vc_x, half.uc_y, half.vc_y, cg.divg_d,
            grid, halo, dt, config.d_sw,
        )
    if checkpointer is not None:
        checkpointer("D_SW-Out", u=ds.u, v=ds.v, delp=ds.delp, pt=ds.pt,
                     w=ds.w if half.w_x is not None else None)
    pt = ds.pt
    if ds.heat is not None and config.d_sw.d_con > 0.0:
        # dissipation heating: dT = d_con*heat/cv_air capped at
        # +-delt_max*dt (a clamp against spurious hot spots at strong
        # shear); pt is potential temperature, so divide by the mid-substep
        # Exner function
        d_t = (config.d_sw.d_con / constants.CV_AIR) * ds.heat
        cap = config.delt_max * abs(dt)
        pt = pt + torch.clamp(d_t, -cap, cap) / half.pkz_c
    delp_h, pt_h = halo.update_scalars([ds.delp, pt], fold="x")
    out = dict(ds=ds, u=ds.u, v=ds.v, delp=delp_h, pt=pt_h, mfx=ds.mfx, mfy=ds.mfy, crx=ds.crx,
               cry=ds.cry, xfx=ds.xfx, yfx=ds.yfx, heat=ds.heat)
    if hydro:
        return DGridHalf(**out)

    # advect the interface heights with the substep fluxes, derive the
    # terrain-following surface w, then the implicit vertical solve; the
    # heights were built by the C-grid half from the same delz and phis folds
    phis_x, _phis_y = half.phis_folds
    with stage_range("UpdateDZ"):
        zh_adv = updatedz_d(half.zh_x, half.zh_y, ds.crx, ds.cry, ds.xfx, ds.yfx, grid, dt)
    zs = half.zh_x[..., -1:, :, :]
    ws = (zh_adv[..., -1:, :, :] - zs)[..., 0, :, :] / torch.tensor(
        dt, dtype=zs.dtype, device=zs.device)
    zh_adv = torch.cat([zh_adv[..., :-1, :, :], zs], dim=-3)
    delz = zh_adv[..., 1:, :, :] - zh_adv[..., :-1, :, :]

    _pe, _peln, pk_h, pkz_h, _gz = hydrostatic_interfaces(delp_h, pt_h, phis, ptop)
    with stage_range("Riemann3"):
        w, delz, pp = riem_solver3(
            ds.w, delz, pt_h, delp_h, pkz_h, ws, dt, ptop, a_imp=config.a_imp,
            p_fac=config.p_fac,
        )
    # the solver's halo columns used garbage ws (fluxes are only valid on
    # the domain): refresh the ghosts with owner values
    w, delz = halo.update_scalars([w, delz], fold="x")
    pp = halo.update_scalar(pp, fold="x")
    gz_if = heights_from_delz(delz, phis_x) * constants.GRAV
    return DGridHalf(**out, w=w, delz=delz, pp=pp, pk=pk_h, pkz=pkz_h, gz=gz_if, ws=ws)


@dataclasses.dataclass(frozen=True)
class AcousticResult:
    """The state after ``n_split`` substeps and the transport quantities
    summed over them."""

    u: torch.Tensor
    v: torch.Tensor
    w: Optional[torch.Tensor]
    delp: torch.Tensor
    pt: torch.Tensor
    delz: Optional[torch.Tensor]
    # accumulated over the n_split substeps, for tracer transport
    mfxd: torch.Tensor
    mfyd: torch.Tensor
    cxd: torch.Tensor
    cyd: torch.Tensor
    xfxd: torch.Tensor
    yfxd: torch.Tensor
    #: damping-dissipated KE accumulated over the substeps [J/kg]
    diss_est: Optional[torch.Tensor] = None


def acoustic_loop(u, v, w, delp, pt, phis, grid, halo, config: AcousticConfig,
                  dt_atmos_k: float, delz=None, checkpointer=None) -> AcousticResult:
    """Run ``n_split`` acoustic substeps of length ``dt_atmos_k / n_split``.

    Inputs are stacked tensors (S, [K,] Y, X); ``pt`` is virtual potential
    temperature, ``phis`` surface geopotential (S, Y, X). The
    nonhydrostatic configuration also carries ``w`` and ``delz``.

    Beta off-centering (``beta != 0``) applies ``(1-beta) PGF(new state) +
    beta PGF(previous substep)``. Hydrostatic: the carried increment is
    seeded with the PGF of the initial state. Nonhydrostatic: the first
    substep applies the full PGF and the blend starts at the second (the
    perturbation pressure has no initial value). The substeps run as a
    Python loop; each one's intermediates are released when it returns.
    A stage ``checkpointer`` sees each substep's ``C_SW-In``, ``C_SW-Out``
    and ``D_SW-Out``.
    """
    if not config.hydrostatic and (w is None or delz is None):
        raise ValueError("nonhydrostatic mode requires w and delz")
    use_beta = config.beta != 0.0
    dt = dt_atmos_k / config.n_split
    dt2 = 0.5 * dt
    ptop = grid.ptop
    track_heat = config.d_sw.d_con > 0.0 or config.d_sw.vtdm4 > 0.0
    # phis is constant over the substeps: exchange its halo once here
    phis_folds = halo.update_scalar_folds(phis)

    dugf = None
    if use_beta and config.hydrostatic:
        delp_h0, pt_h0 = halo.update_scalars([delp, pt], fold="x")
        _pe, _pl, pk0, _pz, gz0 = hydrostatic_interfaces(delp_h0, pt_h0, phis, ptop)
        u0p, v0p = one_grad_p(u, v, pk0, gz0, grid, dt)
        dugf = (u0p - u, v0p - v)
        del delp_h0, pt_h0, pk0, gz0, u0p, v0p

    n_acc = 7 if track_heat else 6
    acc = None
    for _ in range(config.n_split):
        res = _one_substep(u, v, w, delp, pt, delz, phis, grid, halo, config, dt, dt2, ptop,
                           phis_folds=phis_folds, dugf_prev=dugf, checkpointer=checkpointer)
        u, v, w, delp, pt, delz = res[:6]
        new = res[6:6 + n_acc]
        # a zero start would add nothing: the first substep's values are the sums
        acc = list(new) if acc is None else [a + b for a, b in zip(acc, new)]
        dugf = res[6 + n_acc] if use_beta else None
        del res, new
    mfxd, mfyd, cxd, cyd, xfxd, yfxd = acc[:6]
    return AcousticResult(
        u=u, v=v, w=w, delp=delp, pt=pt, delz=delz, mfxd=mfxd, mfyd=mfyd, cxd=cxd, cyd=cyd,
        xfxd=xfxd, yfxd=yfxd, diss_est=acc[6] if track_heat else None,
    )


def _one_substep(u, v, w, delp, pt, delz, phis, grid, halo, config, dt, dt2, ptop,
                 phis_folds=None, dugf_prev=None, checkpointer=None):
    """One acoustic substep; returns ``(u, v, w, delp, pt, delz, mfx, mfy,
    cx, cy, xfx, yfx[, heat][, (du_pgf, dv_pgf)])`` as ``pace_tpu``'s does.
    ``dugf_prev``: the previous substep's D-grid pressure-gradient increments
    when beta off-centering is active."""
    hydro = config.hydrostatic
    if hydro:
        w, delz = None, None
    chalf = c_grid_half(u, v, w, delp, pt, delz, phis, grid, halo, config, dt2, ptop,
                        phis_folds=phis_folds, checkpointer=checkpointer)
    dh = d_grid_half(chalf, grid, halo, config, dt, ptop, phis, checkpointer=checkpointer)
    del chalf
    u, v, w, delz = dh.u, dh.v, dh.w, dh.delz
    beta = config.beta
    dugf_new = None
    if hydro:
        # forward-backward: the pressure gradient of the new delp, pt
        _pe, _peln, pk, _pkz, gz = hydrostatic_interfaces(dh.delp, dh.pt, phis, ptop)
        with stage_range("PGradD"):
            u2, v2 = one_grad_p(u, v, pk, gz, grid, dt)
            del pk, gz
            if dugf_prev is not None:
                du, dv = u2 - u, v2 - v
                u = u + (1.0 - beta) * du + beta * dugf_prev[0]
                v = v + (1.0 - beta) * dv + beta * dugf_prev[1]
                dugf_new = (du, dv)
            else:
                u, v = u2, v2
    else:
        with stage_range("PGradD"):
            u2, v2 = nh_p_grad(u, v, dh.pk, dh.gz, dh.pp, dh.delp, grid, dt)
            if beta != 0.0:
                # the same blend, seeded by a full-PGF first substep (see acoustic_loop)
                du, dv = u2 - u, v2 - v
                if dugf_prev is not None:
                    u = u + (1.0 - beta) * du + beta * dugf_prev[0]
                    v = v + (1.0 - beta) * dv + beta * dugf_prev[1]
                else:
                    u, v = u2, v2
                dugf_new = (du, dv)
            else:
                u, v = u2, v2
    del u2, v2
    if config.rf_fast and config.tau > 0.0:
        # Rayleigh damping inside the substep, over the static reference
        # pressure (ak, bk at P_REF): a (K,) profile broadcast to the layers
        pe_ref = grid.ak + grid.bk * constants.P_REF
        pmid_ref = 0.5 * (pe_ref[1:] + pe_ref[:-1])
        pe_mid = pmid_ref[:, None, None].expand(dh.delp.shape[-3:])
        u, v, w = ray_fast(u, v, w, pe_mid, dt, ptop, config.rf_cutoff, config.tau)
    u, v = halo.sync_vector_interfaces(u, v, kind="dgrid")
    out = (u, v, w, dh.delp, dh.pt, delz, dh.mfx, dh.mfy, dh.crx, dh.cry, dh.xfx, dh.yfx)
    if dh.heat is not None:
        out = out + (dh.heat,)
    if dugf_new is not None:
        out = out + (dugf_new,)
    return out
