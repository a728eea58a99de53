"""Thermodynamic sea ice (0-layer Semtner slab).

Port of ``pace_tpu.models.shield.seaice`` (reference role: the sea-ice
scheme pySHiELD ports standalone): a pure function over dense (.., Y, X)
surface planes, branchless through ``torch.where`` (ice-covered and
ice-free points run the same program). Semtner (1976) 0-layer model:

- the ice+snow slab conducts F_c = (T_freeze_ocean - T_s) / (h_i/k_i +
  h_s/k_s), the same through the whole slab;
- the surface temperature solves (1-a)*SW + e*LW_dn - e*sigma*Ts^4 - H - LE
  + F_c = 0 by Newton iteration, capped at the melting point; the capped-out
  surplus melts snow first, then ice;
- the ice bottom grows when the conductive flux exceeds the ocean's heat
  flux (rho_i L_f dh/dt = F_c - F_ocean) and melts otherwise;
- frozen precipitation accumulates as snow on the ice.

Ice-free points are open ocean at the prescribed mixed-layer temperature
(or, with ``slab_ocean``, a prognostic mixed layer) until the column
freezes new ice.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants
from ...dtypes import resolve_device
from .microphysics import d_saturation_mixing_ratio_dt, over, saturation_mixing_ratio
from .radiation import SIGMA_SB, pow4

RHO_ICE = 917.0      #: [kg/m^3]
RHO_SNOW = 330.0
RHO_WATER = 1000.0
K_ICE = 2.03         #: conductivity [W/m/K]
K_SNOW = 0.31
T_FREEZE_OCEAN = 271.35  #: seawater freezing point [K]
T_MELT = constants.TICE  #: fresh-ice surface melting point


@dataclasses.dataclass(frozen=True)
class SeaIceConfig:
    """Tuning knobs (Semtner-like defaults): ``pace_tpu``'s fields and
    defaults."""

    albedo_ice: float = 0.6
    albedo_snow: float = 0.75
    albedo_ocean: float = 0.06
    emissivity: float = 0.97
    z0: float = 5.0e-4           #: roughness over ice [m]
    karman: float = 0.4
    ocean_heat_flux: float = 2.0  #: mixed-layer flux to the ice bottom [W/m^2]
    sst: float = 274.0           #: open-ocean mixed-layer temperature [K]
    h_min: float = 0.01          #: below this the point is ice-free [m]
    newton_iters: int = 3
    #: --- slab ocean: prognostic mixed-layer SST for open water; without it
    #: open water sits at the fixed cfg.sst
    slab_ocean: bool = False
    mixed_layer_depth: float = 30.0  #: slab depth [m]


@dataclasses.dataclass
class SeaIceState:
    """Prognostic ice state (per surface point)."""

    h_ice: torch.Tensor   #: ice thickness [m]        (.., Y, X)
    h_snow: torch.Tensor  #: snow depth on ice [m]    (.., Y, X)
    tsfc: torch.Tensor    #: surface temperature [K]  (.., Y, X)
    sst: torch.Tensor     #: mixed-layer ocean temperature [K] (.., Y, X)

    @classmethod
    def init(cls, shape, h0=1.0, t0=265.0, sst0=None, dtype=torch.float32, device="cuda"):
        """Uniform initial ice state over horizontal ``shape`` (.., Y, X)."""
        if sst0 is None:
            sst0 = max(t0, T_FREEZE_OCEAN)
        kw = dict(dtype=dtype, device=resolve_device(device))
        shape = tuple(shape)
        return cls(
            h_ice=torch.full(shape, h0, **kw),
            h_snow=torch.zeros(shape, **kw),
            tsfc=torch.full(shape, t0, **kw),
            sst=torch.full(shape, sst0, **kw),
        )


def seaice_step(t1, qv1, wind1, z1, p_sfc, sw_dn, lw_dn, precip, state: SeaIceState, dt: float,
                cfg: SeaIceConfig):
    """One sea-ice step. Forcing arguments as in ``lsm.lsm_step``; returns
    ``(fluxes, new_state)`` with the same flux convention (W/m^2 and the
    kinematic forms for the PBL and SAS). ``state`` is not written."""
    cp, lv = constants.CP_AIR, constants.HLV
    ls = lv + constants.HLF  # sublimation
    wind = torch.clamp(wind1, min=0.1)
    rho = p_sfc / (constants.RDGAS * t1 * (1.0 + constants.ZVIR * qv1))
    ch = over(cfg.karman, torch.log(torch.clamp(z1 / cfg.z0, min=1.1))) ** 2 * wind

    icy = state.h_ice >= cfg.h_min
    snowy = state.h_snow > 1.0e-4
    albedo = torch.where(
        icy, torch.where(snowy, cfg.albedo_snow, torch.full_like(t1, cfg.albedo_ice)),
        cfg.albedo_ocean)
    sw_abs = (1.0 - albedo) * sw_dn
    emis = cfg.emissivity
    lheat = torch.where(icy, ls, torch.full_like(t1, lv))

    # slab conductance (h guarded for the ice-free branch; masked out below)
    resist = torch.clamp(state.h_ice, min=cfg.h_min) / K_ICE + state.h_snow / K_SNOW
    cond = over(1.0, resist)

    def balance(ts):
        qs = saturation_mixing_ratio(ts, p_sfc)
        h = rho * cp * ch * (ts - t1)
        le = rho * lheat * ch * torch.clamp(qs - qv1, min=0.0)
        rad = sw_abs + emis * lw_dn - emis * SIGMA_SB * pow4(ts)
        fc = cond * (T_FREEZE_OCEAN - ts)
        return rad - h - le + fc

    sst_open = state.sst if cfg.slab_ocean else torch.full_like(state.tsfc, cfg.sst)
    ts = torch.where(icy, state.tsfc, sst_open)
    for _ in range(cfg.newton_iters):
        qs = saturation_mixing_ratio(ts, p_sfc)
        dqsdt = d_saturation_mixing_ratio_dt(ts, p_sfc, qs)
        evaporating = (qs - qv1) > 0.0
        dfdt = (
            -4.0 * emis * SIGMA_SB * (ts * ts * ts)
            - rho * cp * ch
            - torch.where(evaporating, rho * lheat * ch * dqsdt, 0.0)
            - cond
        )
        ts = ts - balance(ts) / dfdt
    # melting cap: the surplus energy melts snow first, then ice
    ts_capped = torch.clamp(ts, max=T_MELT)
    melt_flux = torch.where(icy & (ts > T_MELT), torch.clamp(balance(ts_capped), min=0.0), 0.0)
    ts = torch.where(icy, ts_capped, sst_open)

    melt_m = melt_flux * dt / (constants.HLF * RHO_SNOW)  # as snow depth
    snow_melt = torch.minimum(melt_m, state.h_snow)
    leftover_flux = melt_flux * (1.0 - snow_melt / torch.clamp(melt_m, min=1e-30))
    ice_surf_melt = torch.minimum(leftover_flux * dt / (constants.HLF * RHO_ICE), state.h_ice)

    # bottom growth/melt: rho_i * Lf * dh/dt = F_c - F_ocean
    fc = torch.where(icy, cond * (T_FREEZE_OCEAN - ts), 0.0)
    dh_bottom = torch.where(
        icy, dt * (fc - cfg.ocean_heat_flux) / (constants.HLF * RHO_ICE), 0.0)
    # ice-free ocean freeze-up. Slab mode: the mixed-layer SST follows the
    # surface energy balance, and the cooling that would take it below
    # freezing freezes new ice instead. Fixed-SST mode: freeze at the rate of
    # the balance deficit at T_freeze.
    cw_slab = RHO_WATER * 4218.0 * cfg.mixed_layer_depth  # [J/m^2/K]
    if cfg.slab_ocean:
        # open-water balance at the slab temperature (no conduction term)
        qs_o = saturation_mixing_ratio(sst_open, p_sfc)
        net_open = (
            (1.0 - cfg.albedo_ocean) * sw_dn
            + emis * lw_dn - emis * SIGMA_SB * pow4(sst_open)
            - rho * cp * ch * (sst_open - t1)
            - rho * lv * ch * torch.clamp(qs_o - qv1, min=0.0)
            + cfg.ocean_heat_flux
        )
        sst_raw = sst_open + dt * net_open / cw_slab
        freeze_def = torch.clamp(T_FREEZE_OCEAN - sst_raw, min=0.0) * cw_slab
        new_ice = torch.where(~icy, freeze_def / (constants.HLF * RHO_ICE), 0.0)
        sst_new = torch.where(icy, T_FREEZE_OCEAN, torch.clamp(sst_raw, min=T_FREEZE_OCEAN))
    else:
        deficit = -(balance(torch.full_like(ts, T_FREEZE_OCEAN)) + cfg.ocean_heat_flux)
        new_ice = torch.where(~icy & (deficit > 0.0),
                              dt * deficit / (constants.HLF * RHO_ICE), 0.0)
        sst_new = state.sst

    is_frozen = t1 < constants.TICE
    snowfall = torch.where(icy & is_frozen, precip, 0.0)  # [kg/m^2/s]

    h_ice_new = torch.clamp(
        torch.where(icy, state.h_ice + dh_bottom - ice_surf_melt, new_ice), min=0.0)
    h_snow_new = torch.clamp(
        torch.where(icy, state.h_snow + dt * snowfall / RHO_SNOW - snow_melt, 0.0), min=0.0)
    # snow on vanished ice is gone (dumped to the ocean)
    h_snow_new = torch.where(h_ice_new >= cfg.h_min, h_snow_new, 0.0)

    qs = saturation_mixing_ratio(ts, p_sfc)
    shf = rho * cp * ch * (ts - t1)
    evap = rho * ch * torch.clamp(qs - qv1, min=0.0)
    lhf = lheat * evap
    rnet = sw_abs + emis * lw_dn - emis * SIGMA_SB * pow4(ts)

    new_state = SeaIceState(h_ice=h_ice_new, h_snow=h_snow_new, tsfc=ts, sst=sst_new)
    fluxes = {
        "shf": shf,
        "lhf": lhf,
        "conductive": fc,
        "net_radiation": rnet,
        "evap": evap,
        "bottom_growth": torch.where(icy, dh_bottom, new_ice) / dt,
        "sensible_heat_flux": shf / (rho * cp),
        "latent_heat_flux": evap / rho,
    }
    return fluxes, new_state
