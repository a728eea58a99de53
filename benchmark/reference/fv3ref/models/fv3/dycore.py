"""DynamicalCore: the k_split loop of acoustic dynamics, tracer transport and
vertical remapping.

Port of ``pace_tpu.models.fv3.dycore`` (reference role:
``pyFV3.DynamicalCore`` / ``step_dynamics``: for each of ``k_split`` outer
steps, AcousticDynamics ("DynCore"), TracerAdvection and
LagrangianToEulerian ("Remapping"), then the fv_dynamics tail). The step
runs eagerly: the ``k_split`` scan of ``pace_tpu`` is a Python loop, and the
tensors of each outer step are released when it ends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from ... import constants
from ...constants import TRACER_NAMES
from ...ops.d2a2c import d2a2c_vect
from ...ops.d_sw import DSWConfig
from ...ops.dycore_extras import (
    apply_sponge,
    global_energy_fix_increment,
    neg_adj3,
    ray_fast,
    sat_adjust,
    total_energy_columns,
)
from ...ops.moist_cv import compute_q_con, moist_cv
from ...ops.remapping import pe_at_u_points, pe_at_v_points, remap_field, remap_tracers
from ...ops.stencil_utils import scalar_like
from ...ops.tracer_advection import advect_tracers, subcycle_count
from ...utils.ranges import stage_range
from ..shield.microphysics import MicrophysicsConfig
from .acoustics import AcousticConfig, acoustic_loop
from .state import DycoreState

#: the six water species the saturation adjustment updates, in its order
_WATER = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")


@dataclasses.dataclass(frozen=True)
class DynamicalCoreConfig:
    """The dycore namelist subset of ``pace_tpu``'s ``DynamicalCoreConfig``,
    every field and default. Values it does not implement are refused in
    ``__post_init__`` as there."""

    npz: int = 79
    k_split: int = 1
    n_split: int = 1
    hydrostatic: bool = True
    hord_mt: int = 6
    hord_vt: int = 6
    hord_tm: int = 6
    hord_dp: int = 6
    hord_tr: int = 8
    kord_mt: int = 9
    kord_tm: int = -9
    kord_tr: int = 9
    kord_wz: int = 9
    nord: int = 1
    d2_bg: float = 0.0
    d2_bg_k1: float = 0.0
    d2_bg_k2: float = 0.0
    d4_bg: float = 0.16
    dddmp: float = 0.0
    d_con: float = 0.0
    do_vort_damp: bool = False
    vtdm4: float = 0.0
    damp_w: float = 0.0
    #: tile-edge del-2 divergence-damping band (see DSWConfig.edge_damp_band)
    edge_damp_band: bool = True
    #: reference-style divg_u/divg_v damping weights (DSWConfig.lap_divg_weights)
    lap_divg_weights: bool = False
    ke_bg: float = 0.0
    delt_max: float = 0.002
    do_qa: bool = False
    fv_sg_adj: int = 0
    n_sponge: int = 0
    d_ext: float = 0.0
    rf_cutoff: float = 7.5e2
    rf_fast: bool = False
    tau: float = 0.0
    consv_te: float = 0.0
    z_tracer: bool = True
    fill: bool = False
    do_sat_adj: bool = False
    nwat: int = 6
    n_split_tracer: int = 1
    #: derive the tracer sub-cycle count from the global max Courant number
    #: each outer step; n_split_tracer becomes the minimum
    tracer_dynamic_subcycle: bool = True
    a_imp: float = 1.0
    p_fac: float = 0.05
    beta: float = 0.0
    # the saturation-adjustment family the dycore shares with the GFDL
    # microphysics
    tau_l2v: float = 300.0
    tau_v2l: float = 150.0
    tau_i2s: float = 1000.0
    tau_g2v: float = 1200.0
    ql_gen: float = 1.0e-3
    ql_mlt: float = 2.0e-3
    qs_mlt: float = 1.0e-6
    qi_lim: float = 1.0
    dw_ocean: float = 0.10
    dw_land: float = 0.20
    icloud_f: int = 0

    def __post_init__(self):
        # accepted-but-unimplemented namelist values are errors, not no-ops
        if self.ke_bg != 0.0:
            raise ValueError(
                "ke_bg background KE damping is not implemented; the"
                " reference perf configs set ke_bg: 0. — remove the key or"
                " set it to 0"
            )
        if not self.z_tracer:
            raise ValueError(
                "only the z_tracer=true layer-by-layer 2-D tracer transport"
                " scheme is implemented (tracer_2d_1l, the reference's"
                " production path); z_tracer=false has no equivalent here"
            )

    def sat_adjust_config(self) -> MicrophysicsConfig:
        """The microphysics configuration of the saturation-adjustment
        namelist the dycore shares with the GFDL microphysics (used by
        ``do_sat_adj`` in the Remapping stage)."""
        return MicrophysicsConfig(
            tau_l2v=self.tau_l2v,
            tau_v2l=self.tau_v2l,
            tau_i2s=self.tau_i2s,
            tau_g2v=self.tau_g2v,
            ql_gen=self.ql_gen,
            ql_mlt=self.ql_mlt,
            qs_mlt=self.qs_mlt,
            qi_lim=self.qi_lim,
            dw_ocean=self.dw_ocean,
            dw_land=self.dw_land,
            icloud_f=self.icloud_f,
            do_qa=self.do_qa,
        )

    def acoustic(self) -> AcousticConfig:
        return AcousticConfig(
            n_split=self.n_split,
            hydrostatic=self.hydrostatic,
            d_sw=DSWConfig(
                hord_mt=self.hord_mt,
                hord_vt=self.hord_vt,
                hord_tm=self.hord_tm,
                hord_dp=self.hord_dp,
                nord=self.nord,
                d2_bg=self.d2_bg,
                d2_bg_k1=self.d2_bg_k1,
                d2_bg_k2=self.d2_bg_k2,
                d4_bg=self.d4_bg,
                dddmp=self.dddmp,
                damp_w=self.damp_w,
                do_vort_damp=self.do_vort_damp,
                vtdm4=self.vtdm4,
                d_con=self.d_con,
                edge_damp_band=self.edge_damp_band,
                lap_divg_weights=self.lap_divg_weights,
            ),
            a_imp=self.a_imp,
            p_fac=self.p_fac,
            beta=self.beta,
            delt_max=self.delt_max,
            rf_fast=self.rf_fast,
            rf_cutoff=self.rf_cutoff,
            tau=self.tau,
        )


def _interfaces(delp, ptop: float):
    """Interface pressures ``ptop + cumsum(delp)`` with ``ptop`` on top."""
    below = ptop + torch.cumsum(delp, dim=-3)
    return torch.cat([torch.full_like(below[..., :1, :, :], ptop), below], dim=-3)


def _lagrangian_pkz(delp, ptop: float):
    """The layer-mean Exner function of the Lagrangian surfaces before the
    remap, from their log pressures (the ``consv_te`` fixer's te1)."""
    peln = torch.log(_interfaces(delp, ptop))
    pk = torch.exp(constants.KAPPA * (peln - math.log(constants.P_REF)))
    return (pk[..., 1:, :, :] - pk[..., :-1, :, :]) / (
        constants.KAPPA * (peln[..., 1:, :, :] - peln[..., :-1, :, :]))


class DynamicalCore:
    """One dycore step over the stacked-shard state, on the device of the
    grid's tensors.

    Usage::

        core = DynamicalCore(grid_data, halo, config, dt_atmos)
        state = core.step_dynamics(state)

    ``checkpointer``: an optional stage checkpointer
    (:mod:`pace_tpu_torch.testing.checkpointer`), called as
    ``checkpointer(stage, **variables)`` at ``pace_tpu``'s stages, with its
    names and variables, in its order: ``FVDynamics-In``, then for each
    outer step ``C_SW-In``, ``C_SW-Out`` and ``D_SW-Out`` in each acoustic
    substep, ``Tracer2D1L-In``, ``Tracer2D1L-Out``, ``Remapping-In`` and
    ``Remapping-Out``, and last ``FVDynamics-Out``. Without one the step
    fires nothing.
    """

    def __init__(self, grid, halo, config: DynamicalCoreConfig, timestep: float,
                 checkpointer=None):
        self.checkpointer = checkpointer
        self.grid = grid
        self.halo = halo
        self.config = config
        self.timestep = float(timestep)
        self._sat_adjust_config = config.sat_adjust_config()
        #: tracer sub-cycles of each outer step of the last call
        self.tracer_subcycles: List[int] = []
        #: with consv_te > 0, the energy fixer's increment [K] of each outer
        #: step of the last call (0-dim tensors on the state's device)
        self.energy_fix_dT: List[torch.Tensor] = []

    def step_dynamics(self, state: DycoreState) -> DycoreState:
        """The state after one step of ``timestep`` seconds; the input state
        is not written."""
        cfg = self.config
        grid = self.grid
        u, v, w = state.u, state.v, state.w
        delp, pt, q, delz = state.delp, state.pt, state.q, state.delz
        if cfg.hydrostatic:
            w = None
            delz = None
        self.tracer_subcycles = []
        self.energy_fix_dT = []
        ckpt = self.checkpointer
        if ckpt is not None:
            ckpt("FVDynamics-In", u=u, v=v, w=w, delp=delp, pt=pt, q=q, delz=delz)
        diss_acc = None
        for _ in range(cfg.k_split):
            u, v, w, delp, pt, q, delz, aux = self._k_split_body(
                u, v, w, delp, pt, q, delz, state.phis)
            pkz, omga, mfxd, mfyd, cxd, cyd, diss = aux
            # diss_est accumulates across outer steps; the rest keep the last
            if diss is not None:
                diss_acc = diss if diss_acc is None else diss_acc + diss

        # interface-pressure diagnostics from the final delp
        pe = _interfaces(delp, grid.ptop)
        ps = pe[..., -1, :, :]
        peln = torch.log(pe)
        pk = (pe / scalar_like(constants.P_REF, pe)) ** constants.KAPPA

        # A/C-grid wind diagnostics from the post-remap D-grid winds
        u_y, v_x = self.halo.update_vector_fold_pair(u, v, kind="dgrid")
        ua, va, uc, vc, _, _ = d2a2c_vect(u_y, v_x, grid)
        del u_y, v_x
        if ckpt is not None:
            ckpt("FVDynamics-Out", u=u, v=v, w=w, delp=delp, pt=pt, q=q, delz=delz)

        return dataclasses.replace(
            state, u=u, v=v, ua=ua, va=va, uc=uc, vc=vc,
            w=w if w is not None else state.w,
            delz=delz if delz is not None else state.delz,
            delp=delp, pt=pt, q=q, pe=pe, peln=peln, pk=pk, pkz=pkz, ps=ps,
            mfxd=mfxd, mfyd=mfyd, cxd=cxd, cyd=cyd,
            diss_estd=diss_acc if diss_acc is not None else state.diss_estd,
            omga=omga if state.omga is not None else None,
            q_con=compute_q_con(q, cfg.nwat) if state.q_con is not None else None,
        )

    def _k_split_body(self, u, v, w, delp, pt, q, delz, phis):
        """One outer (Lagrangian) step: acoustic loop, tracer transport,
        vertical remap and the fv_dynamics tail."""
        cfg = self.config
        grid, halo = self.grid, self.halo
        dt_k = self.timestep / cfg.k_split
        ckpt = self.checkpointer
        delp0 = delp
        # the stage ranges carry the reference's timer names, which the
        # driver's stage profile reads
        with stage_range("DynCore"):
            res = acoustic_loop(u, v, w, delp, pt, phis, grid, halo, cfg.acoustic(), dt_k,
                                delz=delz, checkpointer=ckpt)
        u, v, w, delz = res.u, res.v, res.w, res.delz
        if ckpt is not None:
            ckpt("Tracer2D1L-In", q=q, delp=delp0)

        # tracer transport through the accumulated mass fluxes; the sub-cycle
        # count (one host sync) is taken here so that the step can report it
        with stage_range("TracerAdvection"):
            n_sub = (subcycle_count(res.cxd, res.cyd, grid.n_halo, cfg.n_split_tracer)
                     if cfg.tracer_dynamic_subcycle else cfg.n_split_tracer)
            self.tracer_subcycles.append(n_sub)
            q, _dp = advect_tracers(q, delp0, res.cxd, res.cyd, res.xfxd, res.yfxd, res.mfxd,
                                    res.mfyd, halo, grid, hord=cfg.hord_tr, n_split=n_sub,
                                    dynamic=False)
        del _dp
        delp, pt = res.delp, res.pt
        if ckpt is not None:
            ckpt("Tracer2D1L-Out", q=q)
            ckpt("Remapping-In", u=u, v=v, w=w, delp=delp, pt=pt, q=q, delz=delz)

        with stage_range("Remapping"):
            # vertical remap back to the hybrid reference coordinate; the
            # Eulerian mid-level pressures at the interval start (from the
            # pre-acoustic delp) give the omga = Dp/Dt diagnostic
            if cfg.consv_te > 0.0:
                te1 = total_energy_columns(u, v, w, delp, pt,
                                           _lagrangian_pkz(delp, grid.ptop), phis)
            pe0 = _interfaces(delp0, grid.ptop)
            pe_old_mid = 0.5 * (pe0[..., 1:, :, :] + pe0[..., :-1, :, :])
            del pe0, delp0
            u, v, w, delz, delp, pt, q, pe, peln, pkz, omga = self._remap(
                u, v, w, delz, delp, pt, q, pe_old_mid=pe_old_mid, mdt=dt_k)
            if cfg.consv_te > 0.0:
                # the global total-energy fixer: the remap's energy change over
                # the whole cube, returned as one uniform heating, weighted by
                # the moist heat capacity
                te2 = total_energy_columns(u, v, w, delp, pt, pkz, phis)
                cvm, _q_con = moist_cv(q, cfg.nwat)
                dT = global_energy_fix_increment(te1, te2, cvm, delp, grid.area, grid.n_halo,
                                                 cfg.consv_te)
                del te1, te2, cvm, _q_con
                pt = pt + dT / pkz
                self.energy_fix_dT.append(dT)
            if cfg.do_sat_adj:
                # the fast phase adjustment of all six water species, shared with
                # the GFDL microphysics, at the remap's layer pressures
                p_mid = delp / (peln[..., 1:, :, :] - peln[..., :-1, :, :])
                pt, qv, ql, qi, qr, qs, qg, qa = sat_adjust(
                    pt, *(q[:, TRACER_NAMES.index(n)] for n in _WATER), p_mid=p_mid, pkz=pkz,
                    dt=dt_k, config=self._sat_adjust_config)
                new = dict(zip(_WATER, (qv, ql, qi, qr, qs, qg)))
                if cfg.do_qa and qa is not None:
                    # the qcld tracer takes the diagnostic cloud fraction
                    new["qcld"] = qa
                q = torch.stack([new.get(n, q[:, i]) for i, n in enumerate(TRACER_NAMES)], dim=1)
                del p_mid, qv, ql, qi, qr, qs, qg, qa, new
        if ckpt is not None:
            ckpt("Remapping-Out", u=u, v=v, w=w, delp=delp, pt=pt, q=q, delz=delz)

        # the fv_dynamics tail: sponge, slow Rayleigh damping, fill
        if cfg.n_sponge > 0 and cfg.d_ext > 0.0:
            pt = apply_sponge(pt, None, grid, cfg.n_sponge, cfg.d_ext, dt_k)
        if cfg.tau > 0.0 and not cfg.rf_fast:
            # once per outer step; with rf_fast it ran inside each substep
            pe_mid = 0.5 * (pe[..., 1:, :, :] + pe[..., :-1, :, :])
            u, v, w = ray_fast(u, v, w, pe_mid, dt_k, grid.ptop, cfg.rf_cutoff, cfg.tau)
        if cfg.fill:
            q, pt = neg_adj3(q, delp, pt=pt, pkz=pkz, nwat=cfg.nwat)
        aux = (pkz, omga, res.mfxd, res.mfyd, res.cxd, res.cyd, res.diss_est)
        return u, v, w, delp, pt, q, delz, aux

    def _remap(self, u, v, w, delz, delp, pt, q, pe_old_mid=None, mdt=None):
        """Lagrangian -> Eulerian remap of all state with the kord family per
        field (kord_mt winds, kord_tm temperature, kord_tr tracers, kord_wz
        vertical wind and specific volume). Returns ``(u, v, w, delz, delp,
        pt, q, pe, peln, pkz, omga)`` on the target interfaces ``pe`` (and
        their logarithm ``peln``)."""
        cfg = self.config
        grid = self.grid
        pe1 = _interfaces(delp, grid.ptop)
        ps = pe1[..., -1, :, :]
        pe2 = grid.ak[None, :, None, None] + grid.bk[None, :, None, None] * ps[:, None]

        omga = None
        if pe_old_mid is not None and mdt is not None:
            # the pressure change a parcel on Lagrangian layer k experienced
            pe1_mid = 0.5 * (pe1[..., 1:, :, :] + pe1[..., :-1, :, :])
            omga = (pe1_mid - pe_old_mid) / scalar_like(mdt, pe1)

        pt = remap_field(pt, pe1, pe2, cfg.kord_tm)
        if w is not None:
            w = remap_field(w, pe1, pe2, cfg.kord_wz)
        if delz is not None:
            # remap the specific volume (delz per unit mass) conservatively,
            # then rebuild the thickness on the new layers
            dp1 = pe1[..., 1:, :, :] - pe1[..., :-1, :, :]
            sv = remap_field(delz / dp1, pe1, pe2, abs(cfg.kord_wz))
            delz = sv * (pe2[..., 1:, :, :] - pe2[..., :-1, :, :])
            del sv, dp1
        q = remap_tracers(q, pe1, pe2, cfg.kord_tr)
        # winds: remap on interface-averaged pressure columns
        u = remap_field(u, pe_at_u_points(pe1), pe_at_u_points(pe2), cfg.kord_mt)
        v = remap_field(v, pe_at_v_points(pe1), pe_at_v_points(pe2), cfg.kord_mt)

        delp = pe2[..., 1:, :, :] - pe2[..., :-1, :, :]
        peln = torch.log(pe2)
        kap = constants.KAPPA
        if delz is None:
            pk = (pe2 / scalar_like(constants.P_REF, pe2)) ** kap
            pkz = (pk[..., 1:, :, :] - pk[..., :-1, :, :]) / (
                kap * (peln[..., 1:, :, :] - peln[..., :-1, :, :]))
        else:
            # nonhydrostatic: layer-mean Exner from the gas law
            # p^(1-kappa) = Rd * dm * g * theta_v * P_REF^-kappa / (-delz)
            x = (constants.RDGAS * (delp / scalar_like(constants.GRAV, delp)) * pt
                 / (constants.P_REF**kap * (-delz)))
            p_full = x ** (1.0 / (1.0 - kap))
            pkz = (p_full / scalar_like(constants.P_REF, p_full)) ** kap
        return u, v, w, delz, delp, pt, q, pe2, peln, pkz, omga
