"""The physics entry point and its coupling to the dycore.

Port of ``pace_tpu.models.shield.physics`` (reference roles:
``pySHiELD.Physics`` with ``update_atmos_state.{DycoreToPhysics,
UpdateAtmosphereState}``): copy the dycore state to physics variables, run
the schemes, apply the updates back. The dycore's prognostic ``pt`` is
virtual potential temperature; the physics works on temperature T = pt *
pkz / (1 + zvir qv) and rebuilds ``pt`` with the updated vapor. Wind
tendencies go through :func:`apply_wind_tendencies`, which projects the
A-grid tendency vectors onto the D-grid points.

Every scheme of ``PHYSICS_PACKAGES`` is ported (the GFDL microphysics, the
EDMF PBL, shallow and deep SAS convection, gray and band radiation,
Held-Suarez and the Reed-Jablonowski simple physics), with the dry
convective adjustment (``fv_sg_adj``) and the interactive surfaces of
``surface.py``, whose state :class:`Physics` carries from call to call.
A stage checkpointer sees ``Physics-In`` and ``Physics-Out`` (``u, v, pt,
delp, q``), as ``pace_tpu``'s does. The call runs eagerly and never writes
into the state it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ... import constants
from ...constants import TRACER_NAMES
from ...ops.d2a2c import _dot3, cartesian_wind_centers, centers_to_x_ifaces, centers_to_y_ifaces
from ...ops.stencil_utils import bcast_k
from ...utils.ranges import stage_range
from ..fv3.state import DycoreState
from .band_radiation import BandRadiationConfig, band_radiation_step_fluxes
from .held_suarez import HeldSuarezConfig, held_suarez_step
from .microphysics import MicrophysicsConfig, microphysics_step
from .pbl import PBLConfig, pbl_step
from .radiation import (GrayRadiationConfig, gray_radiation_step_fluxes, sin_latitude,
                        sw_down_surface)
from .sas import DeepConvectionConfig, ShallowConvectionConfig, sas_step
from .simple_physics import SimplePhysicsConfig, simple_physics_step
from .surface import SurfaceConfig, build_surface

PHYSICS_PACKAGES = (
    "GFS_microphysics", "GFS_PBL", "GFS_shallow_convection",
    "GFS_deep_convection", "held_suarez", "gray_radiation",
    "band_radiation", "RJ_simple_physics",
)

_IQ = {name: i for i, name in enumerate(TRACER_NAMES)}


@dataclasses.dataclass
class PhysicsState:
    """Physics-side state (reference pySHiELD.PhysicsState): dycore-copied
    fields on the A grid."""

    qvapor: torch.Tensor
    qliquid: torch.Tensor
    qice: torch.Tensor
    qrain: torch.Tensor
    qsnow: torch.Tensor
    qgraupel: torch.Tensor
    pt: torch.Tensor  # temperature [K]
    delp: torch.Tensor
    p_mid: torch.Tensor
    precip: Optional[torch.Tensor] = None


def _temperature(state: DycoreState, qv):
    """T = pt * pkz / (1 + zvir qv)."""
    return state.pt * state.pkz / (1.0 + constants.ZVIR * qv)


def _p_mid(state: DycoreState):
    return 0.5 * (state.pe[..., 1:, :, :] + state.pe[..., :-1, :, :])


def _with_tracers(q, new: dict):
    """The tracer block ``q`` with the tracers ``new`` (name -> field)
    replaced, as a new tensor."""
    return torch.stack([new.get(name, q[:, i]) for i, name in enumerate(TRACER_NAMES)], dim=1)


def dycore_to_physics(state: DycoreState) -> PhysicsState:
    """Reference DycoreToPhysics: copy/transform dycore -> physics."""
    qv = state.q[:, _IQ["qvapor"]]
    return PhysicsState(
        qvapor=qv,
        qliquid=state.q[:, _IQ["qliquid"]],
        qice=state.q[:, _IQ["qice"]],
        qrain=state.q[:, _IQ["qrain"]],
        qsnow=state.q[:, _IQ["qsnow"]],
        qgraupel=state.q[:, _IQ["qgraupel"]],
        pt=_temperature(state, qv),
        delp=state.delp,
        p_mid=_p_mid(state),
    )


def update_atmosphere_state(state: DycoreState, phy: PhysicsState) -> DycoreState:
    """Reference UpdateAtmosphereState: the physics updates applied back to
    a new dycore state (moisture, and temperature as theta_v)."""
    q = _with_tracers(state.q, {name: getattr(phy, name) for name in (
        "qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")})
    pt_new = phy.pt * (1.0 + constants.ZVIR * phy.qvapor) / state.pkz
    return dataclasses.replace(state, q=q, pt=pt_new)


@dataclasses.dataclass
class TendencyState:
    """Physics wind/temperature tendencies on the A grid (reference
    ``TendencyState`` with u_dt/v_dt/pt_dt)."""

    u_dt: torch.Tensor
    v_dt: torch.Tensor
    pt_dt: torch.Tensor

    @classmethod
    def init_zeros(cls, like) -> "TendencyState":
        z = torch.zeros_like(like)
        return cls(u_dt=z, v_dt=z, pt_dt=z)


def dry_convective_adjustment(pt, q, delp, dt: float, tau: float, n_sweeps: int = 2):
    """fv_sg_adj: relax statically unstable columns toward a mixed state.

    ``pt`` is virtual potential temperature (S, K, Y, X), k increasing
    downward; unstable = theta_v increasing with k. Red-black pairwise
    mass-weighted mixing of adjacent layers (pt and the tracer block ``q``
    (S, nq, K, Y, X) with the same weights), ``n_sweeps`` passes, relaxed
    with factor min(1, dt/tau). Winds are left untouched, as in
    ``pace_tpu``. Returns new tensors.
    """
    relax = min(1.0, dt / max(tau, 1e-30))
    pt0, q0 = pt, q
    stacked = q.ndim == pt.ndim + 1

    def mix_pair(pt, q, k0):
        up = pt[..., k0:-1:2, :, :]
        lo = pt[..., k0 + 1::2, :, :]
        n = min(up.shape[-3], lo.shape[-3])
        up, lo = up[..., :n, :, :], lo[..., :n, :, :]
        ku = slice(k0, k0 + 2 * n, 2)
        kl = slice(k0 + 1, k0 + 1 + 2 * n, 2)
        m_u = delp[..., ku, :, :][..., :n, :, :]
        m_l = delp[..., kl, :, :][..., :n, :, :]
        unstable = up < lo  # theta_v growing downward = unstable
        mixed = (up * m_u + lo * m_l) / (m_u + m_l)
        pt = pt.clone()
        pt[..., ku, :, :] = torch.where(unstable, mixed, up)
        pt[..., kl, :, :] = torch.where(unstable, mixed, lo)
        qu = q[..., ku, :, :][..., :n, :, :]
        ql_ = q[..., kl, :, :][..., :n, :, :]
        mu = m_u[:, None] if stacked else m_u
        ml = m_l[:, None] if stacked else m_l
        uns_q = unstable[:, None] if stacked else unstable
        qmix = (qu * mu + ql_ * ml) / (mu + ml)
        q = q.clone()
        q[..., ku, :, :] = torch.where(uns_q, qmix, qu)
        q[..., kl, :, :] = torch.where(uns_q, qmix, ql_)
        return pt, q

    for _ in range(n_sweeps):
        pt, q = mix_pair(pt, q, 0)
        pt, q = mix_pair(pt, q, 1)
    pt = pt0 + relax * (pt - pt0)
    q = q0 + relax * (q - q0)
    return pt, q


def apply_wind_tendencies(u, v, u_dt, v_dt, grid, dt: float, halo=None):
    """Project A-grid contravariant wind tendencies onto the D-grid points
    and return the updated ``(u, v)``: the Cartesian tendency vector is
    interpolated to each staggered point and projected on its basis.

    Halo columns of the tendencies are undefined (the schemes run on every
    column, and the pressures of ghost columns need not be physical), while
    the interpolation averages neighbouring columns. With ``halo``, the
    three Cartesian components are exchanged (``update_scalar``, centers);
    without it, the halo columns are zeroed by ``where`` (NaN-safe).
    """
    du = u_dt.unsqueeze(-3)
    dv = v_dt.unsqueeze(-3)
    vcart = du * bcast_k(grid.ec1, du) + dv * bcast_k(grid.ec2, dv)
    if halo is not None:
        vcart = halo.update_scalar(vcart, stagger="center")
    else:
        h = grid.n_halo
        ny, nx = vcart.shape[-2], vcart.shape[-1]
        iy = torch.arange(ny, device=vcart.device).view(ny, 1)
        ix = torch.arange(nx, device=vcart.device)
        interior = (iy >= h) & (iy < ny - h) & (ix >= h) & (ix < nx - h)
        vcart = torch.where(interior, vcart, 0.0)
    cy = centers_to_y_ifaces(vcart)  # (.., 3, Y+1, X)
    tend_u = _dot3(cy, bcast_k(grid.es1, cy))
    cx = centers_to_x_ifaces(vcart)  # (.., 3, Y, X+1)
    tend_v = _dot3(cx, bcast_k(grid.ew2, cx))
    return u + dt * tend_u, v + dt * tend_v


class Physics:
    """Reference ``pySHiELD.Physics``: the schemes in ``pace_tpu``'s order
    (dry adjustment, RJ simple physics, Held-Suarez, gray then band
    radiation, the interactive surface, PBL, deep then shallow convection,
    microphysics) on the dycore state.

    Usage::

        physics = Physics(grid, ("gray_radiation", "GFS_PBL", "GFS_microphysics"), 200.0,
                          surface_config=SurfaceConfig(type="land"))
        state = physics(state, time_seconds)

    With an interactive surface (``surface_config.type`` other than
    ``"none"``), ``surface_state`` holds the surface's state between calls:
    built at the first call on the state's device, replaced (not written)
    by each call, with the precipitation rate of the call's microphysics and
    deep convection for the next.
    """

    def __init__(self, grid, schemes, timestep: float, config=None, fv_sg_adj: float = 0.0,
                 pbl_config=None, radiation_config=None, sas_config=None, deep_config=None,
                 surface_config=None, halo=None, checkpointer=None, held_suarez_config=None,
                 band_radiation_config=None):
        for s in schemes:
            if s not in PHYSICS_PACKAGES:
                raise ValueError(f"unknown physics scheme {s!r}; available: {PHYSICS_PACKAGES}")
        self.checkpointer = checkpointer
        self.schemes = tuple(schemes)
        self.timestep = float(timestep)
        self.config = config or MicrophysicsConfig()
        self.pbl_config = pbl_config if pbl_config is not None else PBLConfig()
        self.radiation_config = (radiation_config if radiation_config is not None
                                 else GrayRadiationConfig())
        self.sas_config = sas_config if sas_config is not None else ShallowConvectionConfig()
        self.deep_config = deep_config if deep_config is not None else DeepConvectionConfig()
        self.held_suarez_config = (held_suarez_config if held_suarez_config is not None
                                   else HeldSuarezConfig())
        self.band_radiation_config = (band_radiation_config if band_radiation_config is not None
                                      else BandRadiationConfig())
        self.simple_physics_config = SimplePhysicsConfig()
        self.halo = halo  # for the tendency halo update (None = zero halos)
        self.grid = grid
        self.fv_sg_adj = float(fv_sg_adj)
        self.surface_config = surface_config if surface_config is not None else SurfaceConfig()
        self._surface = build_surface(self.surface_config, grid=lambda: self.grid)
        self.surface_state = None

    def __call__(self, state: DycoreState, time_seconds: float = 0.0) -> DycoreState:
        """The state after the physics of one ``timestep``; ``state`` is not
        written. ``time_seconds``, the model time, is held as float32, as
        ``pace_tpu`` holds it (the diurnal and seasonal insolation read it)."""
        t = np.float32(time_seconds)
        if self._surface is None:
            return self._call_impl(state, None, t)[0]
        if self.surface_state is None:
            self.surface_state = self._surface.init(state.ps.shape, state.ps.dtype,
                                                    device=state.ps.device)
        state, self.surface_state = self._call_impl(state, self.surface_state, t)
        return state

    def _call_impl(self, state: DycoreState, sfc, time_seconds):
        if self.checkpointer is not None:
            self.checkpointer("Physics-In", u=state.u, v=state.v, pt=state.pt,
                              delp=state.delp, q=state.q)
        if self.fv_sg_adj > 0.0:
            with stage_range("DryAdjustment"):
                pt_adj, q_adj = dry_convective_adjustment(state.pt, state.q, state.delp,
                                                          self.timestep, self.fv_sg_adj)
            state = dataclasses.replace(state, pt=pt_adj, q=q_adj)
        if "RJ_simple_physics" in self.schemes:
            with stage_range("SimplePhysics"):
                state = self._simple_physics(state)
        if "held_suarez" in self.schemes:
            u_new, v_new, pt_new = held_suarez_step(
                state.u, state.v, state.pt, state.pkz, _p_mid(state), state.ps, self.grid.f0,
                self.timestep, self.held_suarez_config)
            state = dataclasses.replace(state, u=u_new, v=v_new, pt=pt_new)
        # --- radiation (also supplies the surface's downward fluxes)
        lw_dn_sfc = sw_dn_sfc = None
        t_surf = self._surface.tskin(sfc) if sfc is not None else None
        if "gray_radiation" in self.schemes:
            with stage_range("Radiation"):
                cfg = self.radiation_config
                sinlat = sin_latitude(self.grid.f0)
                pt_new, lw_dn_sfc = gray_radiation_step_fluxes(
                    state.pt, state.pkz, state.pe, state.ps, sinlat * sinlat, self.timestep,
                    cfg, t_surf=t_surf, qv=state.q[:, _IQ["qvapor"]])
                sw_dn_sfc = sw_down_surface(
                    sinlat * sinlat, cfg, lat=self.grid.lat_agrid, lon=self.grid.lon_agrid,
                    time_seconds=time_seconds).expand(state.ps.shape)
                state = dataclasses.replace(state, pt=pt_new)
        if "band_radiation" in self.schemes:
            with stage_range("Radiation"):
                qc = state.q[:, _IQ["qliquid"]] + state.q[:, _IQ["qice"]]
                pt_new, lw_dn_sfc, sw_dn_sfc = band_radiation_step_fluxes(
                    state.pt, state.pkz, state.pe, state.ps, self.timestep,
                    self.band_radiation_config, qv=state.q[:, _IQ["qvapor"]], qc=qc,
                    t_surf=t_surf)
                state = dataclasses.replace(state, pt=pt_new)
        # --- the interactive lower boundary: its fluxes drive the PBL and
        # the convection
        shf = lhf = None
        if sfc is not None:
            with stage_range("Surface"):
                forcing = self._surface_forcing(state, sw_dn_sfc, lw_dn_sfc, sfc)
                fluxes, sfc = self._surface.step(forcing, sfc, self.timestep)
                shf = fluxes["sensible_heat_flux"]
                lhf = fluxes["latent_heat_flux"]
        if "GFS_PBL" in self.schemes:
            with stage_range("PBL"):
                state = self._pbl(state, shf, lhf)
        conv_precip = None
        if "GFS_deep_convection" in self.schemes:
            with stage_range("DeepConvection"):
                state, conv_precip = self._sas(state, self.deep_config, shf, lhf)
        if "GFS_shallow_convection" in self.schemes:
            with stage_range("ShallowConvection"):
                state, _ = self._sas(state, self.sas_config, shf, lhf)
        if "GFS_microphysics" not in self.schemes:
            if sfc is not None and conv_precip is not None:
                sfc = dataclasses.replace(sfc, precip=conv_precip)
            return self._finish(state, sfc)
        phy = dycore_to_physics(state)
        with stage_range("Microphysics"):
            qv, ql, qi, qr, qs, qg, t, precip = microphysics_step(
                phy.qvapor, phy.qliquid, phy.qice, phy.qrain, phy.qsnow, phy.qgraupel, phy.pt,
                phy.p_mid, phy.delp, self.timestep, self.config)
        phy = dataclasses.replace(phy, qvapor=qv, qliquid=ql, qice=qi, qrain=qr, qsnow=qs,
                                  qgraupel=qg, pt=t, precip=precip)
        if sfc is not None:
            # this call's precipitation rate (microphysics and deep
            # convection) for the next call's surface
            rate = precip / self.timestep
            if conv_precip is not None:
                rate = rate + conv_precip
            sfc = dataclasses.replace(sfc, precip=rate)
        return self._finish(update_atmosphere_state(state, phy), sfc)

    def _finish(self, state, sfc):
        if self.checkpointer is not None:
            self.checkpointer("Physics-Out", u=state.u, v=state.v, pt=state.pt,
                              delp=state.delp, q=state.q)
        return state, sfc

    def _surface_forcing(self, state: DycoreState, sw_dn, lw_dn, sfc):
        """The lowest model level's forcing of ``lsm_step`` / ``seaice_step``;
        the surface config's constant radiation where no radiation scheme
        gives it."""
        qv1 = state.q[:, _IQ["qvapor"], -1, :, :]
        t1 = state.pt[..., -1, :, :] * state.pkz[..., -1, :, :] / (1.0 + constants.ZVIR * qv1)
        ua, va = self._a_grid_winds(state)
        wind1 = torch.sqrt(ua[..., -1, :, :] ** 2 + va[..., -1, :, :] ** 2)
        pe_b = state.pe[..., -1, :, :]
        pe_a = state.pe[..., -2, :, :]
        tv1 = t1 * (1.0 + constants.ZVIR * qv1)
        z1 = 0.5 * constants.RDGAS * tv1 / constants.GRAV * torch.log(pe_b / pe_a)
        cfg = self.surface_config
        if sw_dn is None:
            sw_dn = torch.full_like(t1, cfg.sw_dn)
        if lw_dn is None:
            lw_dn = torch.full_like(t1, cfg.lw_dn)
        return dict(t1=t1, qv1=qv1, wind1=wind1, z1=z1, p_sfc=pe_b, sw_dn=sw_dn, lw_dn=lw_dn,
                    precip=sfc.precip)

    def _a_grid_winds(self, state: DycoreState):
        """Contravariant A-grid winds from the D-grid state (d2a2c center leg)."""
        grid = self.grid
        vcart = cartesian_wind_centers(state.u, state.v, grid)
        u_cov = _dot3(vcart, bcast_k(grid.ec1, vcart))
        v_cov = _dot3(vcart, bcast_k(grid.ec2, vcart))
        rsin2 = bcast_k(grid.rsin2, u_cov)
        cosa_s = bcast_k(grid.cosa_s, u_cov)
        ua = (u_cov - v_cov * cosa_s) * rsin2
        va = (v_cov - u_cov * cosa_s) * rsin2
        return ua, va

    def _apply_column_update(self, state, u_dt, v_dt, t_new, new_tracers):
        """The state with a column scheme's A-grid wind tendencies projected
        onto the D grid, its temperature as theta_v and its tracers."""
        u_new, v_new = apply_wind_tendencies(state.u, state.v, u_dt, v_dt, self.grid,
                                             self.timestep, halo=self.halo)
        pt_new = t_new * (1.0 + constants.ZVIR * new_tracers["qvapor"]) / state.pkz
        return dataclasses.replace(state, u=u_new, v=v_new, pt=pt_new,
                                   q=_with_tracers(state.q, new_tracers))

    def _simple_physics(self, state: DycoreState) -> DycoreState:
        ua, va = self._a_grid_winds(state)
        qv = state.q[:, _IQ["qvapor"]]
        u_dt, v_dt, t_new, qv_new, _precip = simple_physics_step(
            ua, va, _temperature(state, qv), qv, state.pe, _p_mid(state), state.delp,
            state.phis, self.timestep, self.simple_physics_config)
        return self._apply_column_update(state, u_dt, v_dt, t_new, {"qvapor": qv_new})

    def _pbl(self, state: DycoreState, shf=None, lhf=None) -> DycoreState:
        ua, va = self._a_grid_winds(state)
        qv = state.q[:, _IQ["qvapor"]]
        u_dt, v_dt, t_new, qv_new, _h = pbl_step(
            ua, va, _temperature(state, qv), qv, state.pe, _p_mid(state), state.delp,
            state.phis, self.timestep, self.pbl_config,
            sensible_heat_flux=shf, latent_heat_flux=lhf)
        return self._apply_column_update(state, u_dt, v_dt, t_new, {"qvapor": qv_new})

    def _sas(self, state: DycoreState, cfg, shf=None, lhf=None):
        """One SAS mass-flux pass (shallow or deep per ``cfg.mode``); returns
        (state, precip_rate)."""
        ua, va = self._a_grid_winds(state)
        qv = state.q[:, _IQ["qvapor"]]
        ql = state.q[:, _IQ["qliquid"]]
        u_dt, v_dt, t_new, qv_new, ql_new, precip = sas_step(
            ua, va, _temperature(state, qv), qv, ql, state.pe, _p_mid(state), state.delp,
            self.timestep, cfg, sensible_heat_flux=shf, latent_heat_flux=lhf)
        return self._apply_column_update(state, u_dt, v_dt, t_new,
                                         {"qvapor": qv_new, "qliquid": ql_new}), precip
