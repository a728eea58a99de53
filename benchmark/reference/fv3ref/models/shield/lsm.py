"""NOAH-style land surface model.

Port of ``pace_tpu.models.shield.lsm`` (reference role: the NOAH LSM that
pySHiELD ports standalone): a pure function of (forcing, LSMState) ->
(fluxes, LSMState) over dense (.., Y, X) surface planes, branchless through
``torch.where``:

- 4 soil layers at the NOAH thicknesses (0.1/0.3/0.6/1.0 m) for temperature
  (implicit heat diffusion, zero-flux bottom) and volumetric moisture
  (inter-layer diffusion, infiltration, saturation-excess runoff), the
  4-layer solves unrolled;
- the surface energy balance solved for the skin temperature by Newton
  iteration, with bulk-aerodynamic H, beta-limited LE and the ground heat
  flux into soil layer 1;
- a snowpack (water equivalent) that caps the skin at freezing and melts
  with the surplus, and raises the albedo.

The fluxes include the kinematic w'T' [K m/s] and w'q' [kg/kg m/s] that the
PBL and SAS schemes take. Soil layer 0 is the top layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import constants
from ...dtypes import resolve_device
from .microphysics import d_saturation_mixing_ratio_dt, over, saturation_mixing_ratio
from .radiation import SIGMA_SB, pow4

#: NOAH standard soil-layer thicknesses [m], top first
SOIL_DZ = (0.1, 0.3, 0.6, 1.0)


@dataclasses.dataclass(frozen=True)
class LSMConfig:
    """Tuning knobs (NOAH-like defaults for a loam-ish soil): ``pace_tpu``'s
    fields and defaults."""

    albedo: float = 0.2          #: snow-free surface albedo
    albedo_snow: float = 0.7     #: deep-snow albedo
    snow_albedo_swe: float = 0.01  #: SWE [m] at which snow albedo saturates
    emissivity: float = 0.95
    z0: float = 0.1              #: roughness length [m] (vegetated land)
    karman: float = 0.4
    soil_conductivity: float = 1.1   #: [W/m/K]
    soil_heat_capacity: float = 2.2e6  #: volumetric [J/m^3/K]
    smcmax: float = 0.45         #: porosity [m^3/m^3]
    smcref: float = 0.30         #: field capacity (beta=1 above this)
    smcwlt: float = 0.10         #: wilting point (beta=0 below this)
    smcdry: float = 0.05         #: air-dry floor for direct evaporation
    soil_diffusivity: float = 2.0e-7  #: moisture diffusivity [m^2/s]
    newton_iters: int = 3


@dataclasses.dataclass
class LSMState:
    """Prognostic land state (per surface point)."""

    tskin: torch.Tensor    #: skin temperature [K]           (.., Y, X)
    stc: torch.Tensor      #: soil temperature [K]        (.., 4, Y, X)
    smc: torch.Tensor      #: volumetric soil moisture    (.., 4, Y, X)
    sneqv: torch.Tensor    #: snow water equivalent [m]      (.., Y, X)

    @classmethod
    def init(cls, shape, t0=288.0, smc0=0.25, dtype=torch.float32, device="cuda"):
        """Uniform initial land state over horizontal ``shape`` (.., Y, X)."""
        kw = dict(dtype=dtype, device=resolve_device(device))
        soil_shape = tuple(shape[:-2]) + (len(SOIL_DZ),) + tuple(shape[-2:])
        return cls(
            tskin=torch.full(tuple(shape), t0, **kw),
            stc=torch.full(soil_shape, t0, **kw),
            smc=torch.full(soil_shape, smc0, **kw),
            sneqv=torch.zeros(tuple(shape), **kw),
        )


def _solve4_tridiag(lower, diag, upper, rhs):
    """Direct solve of a small tridiagonal system along axis -3 (the Thomas
    algorithm unrolled over the 4 soil layers)."""
    n = rhs.shape[-3]
    cp, dp = [], []
    for k in range(n):
        lo = lower[..., k, :, :] if k > 0 else 0.0
        cpk_prev = cp[k - 1] if k > 0 else 0.0
        dpk_prev = dp[k - 1] if k > 0 else 0.0
        denom = diag[..., k, :, :] - lo * cpk_prev
        up = upper[..., k, :, :] if k < n - 1 else torch.zeros_like(denom)
        cp.append(up / denom)
        dp.append((rhs[..., k, :, :] - lo * dpk_prev) / denom)
    xs = [None] * n
    xs[n - 1] = dp[n - 1]
    for k in range(n - 2, -1, -1):
        xs[k] = dp[k] - cp[k] * xs[k + 1]
    return torch.stack(xs, dim=-3)


def lsm_step(t1, qv1, wind1, z1, p_sfc, sw_dn, lw_dn, precip, state: LSMState, dt: float,
             cfg: LSMConfig):
    """One land-surface step.

    Args: lowest-model-level temperature ``t1`` [K], vapor ``qv1``, wind speed
    ``wind1`` [m/s], height ``z1`` [m]; surface pressure [Pa]; downward SW/LW
    radiation [W/m^2]; ``precip`` rate [kg/m^2/s]; all (.., Y, X).

    Returns ``(fluxes, new_state)``: ``fluxes`` holds W/m^2 entries (shf,
    lhf, ground, net_radiation), the evaporation and snowmelt rates, and the
    kinematic ``sensible_heat_flux`` [K m/s] / ``latent_heat_flux``
    [kg/kg m/s] the PBL and shallow convection take. ``state`` is not
    written.
    """
    cp, lv = constants.CP_AIR, constants.HLV
    dz1 = SOIL_DZ[0]
    wind = torch.clamp(wind1, min=0.1)
    rho = p_sfc / (constants.RDGAS * t1 * (1.0 + constants.ZVIR * qv1))

    # bulk exchange coefficient (neutral log law)
    ch = over(cfg.karman, torch.log(torch.clamp(z1 / cfg.z0, min=1.1))) ** 2 * wind

    # snow modifies albedo; deep snow asymptote
    has_snow = state.sneqv > 0.0
    snow_frac = torch.clamp(state.sneqv / cfg.snow_albedo_swe, 0.0, 1.0)
    albedo = cfg.albedo + snow_frac * (cfg.albedo_snow - cfg.albedo)
    sw_abs = (1.0 - albedo) * sw_dn

    # snow cover: sublimation (lv + lf) limited by the snow available this
    # step; bare soil evaporates (lv) under the NOAH beta moisture stress
    lheat = torch.where(has_snow, lv + constants.HLF, torch.full_like(t1, lv))
    qs0 = saturation_mixing_ratio(state.tskin, p_sfc)
    evap_pot = rho * ch * torch.clamp(qs0 - qv1, min=0.0)  # [kg/m^2/s]
    beta_snow = torch.clamp(
        state.sneqv * 1000.0 / (dt * torch.clamp(evap_pot, min=1e-12)), 0.0, 1.0)
    beta = torch.where(
        has_snow,
        beta_snow,
        torch.clamp((state.smc[..., 0, :, :] - cfg.smcwlt) / (cfg.smcref - cfg.smcwlt), 0.0,
                    1.0),
    )

    # --- surface energy balance: Newton solve for tskin
    emis = cfg.emissivity
    cond = 2.0 * cfg.soil_conductivity / dz1
    stc1 = state.stc[..., 0, :, :]

    def balance(ts):
        qs = saturation_mixing_ratio(ts, p_sfc)
        h = rho * cp * ch * (ts - t1)
        le = rho * lheat * ch * beta * torch.clamp(qs - qv1, min=0.0)
        gflux = cond * (ts - stc1)
        rad = sw_abs + emis * lw_dn - emis * SIGMA_SB * pow4(ts)
        return rad - h - le - gflux

    ts = state.tskin
    for _ in range(cfg.newton_iters):
        qs = saturation_mixing_ratio(ts, p_sfc)
        dqsdt = d_saturation_mixing_ratio_dt(ts, p_sfc, qs)
        evaporating = (qs - qv1) > 0.0
        dfdt = (
            -4.0 * emis * SIGMA_SB * (ts * ts * ts)
            - rho * cp * ch
            - torch.where(evaporating, rho * lheat * ch * beta * dqsdt, 0.0)
            - cond
        )
        ts = ts - balance(ts) / dfdt
    # snow cap: with snow on the ground the skin cannot exceed freezing; the
    # surplus energy melts snow instead
    ts_capped = torch.where(has_snow, torch.clamp(ts, max=constants.TICE), ts)
    melt_energy = torch.where(has_snow & (ts > constants.TICE),
                              torch.clamp(balance(ts_capped), min=0.0), 0.0)
    ts = ts_capped
    melt = torch.minimum(melt_energy / (constants.HLF * 1000.0) * dt,
                         state.sneqv)  # [m] of water equivalent (rho_w = 1000)

    # final fluxes at the solved skin temperature
    qs = saturation_mixing_ratio(ts, p_sfc)
    shf = rho * cp * ch * (ts - t1)
    evap = rho * ch * beta * torch.clamp(qs - qv1, min=0.0)  # [kg/m^2/s]
    lhf = lheat * evap
    gflux = cond * (ts - stc1)
    rnet = sw_abs + emis * lw_dn - emis * SIGMA_SB * pow4(ts)

    # --- soil temperature: implicit diffusion with top flux G, zero-flux
    # bottom. The layers' thicknesses, the distances between their centers
    # and the coefficients from them are numbers of the state's precision,
    # as pace_tpu forms them (arrays of that dtype)
    npdt = np.float64 if t1.dtype == torch.float64 else np.float32
    dzs = np.asarray(SOIL_DZ, dtype=npdt)
    dz_between = npdt(0.5) * (dzs[:-1] + dzs[1:])
    kappa = cfg.soil_conductivity / cfg.soil_heat_capacity
    n = len(SOIL_DZ)
    cond_if = npdt(kappa) / dz_between  # interface conductances (3,)
    a = torch.zeros_like(state.stc)  # sub-diagonal factors
    b = torch.zeros_like(state.stc)  # super-diagonal factors
    for k in range(n - 1):
        b[..., k, :, :] = float(npdt(dt) * cond_if[k] / dzs[k])
        a[..., k + 1, :, :] = float(npdt(dt) * cond_if[k] / dzs[k + 1])
    diag = 1.0 + a + b
    # the ground heat flux enters layer 0, explicitly (it was solved with the
    # energy balance above)
    top = state.stc[..., 0, :, :] + dt * gflux / float(npdt(cfg.soil_heat_capacity) * dzs[0])
    rhs = torch.cat([top.unsqueeze(-3), state.stc[..., 1:, :, :]], dim=-3)
    stc_new = _solve4_tridiag(-a, diag, -b, rhs)

    # --- soil moisture: infiltration of rain + snowmelt, beta evaporation
    # from layer 0, inter-layer diffusion, saturation-excess runoff
    is_frozen = t1 < constants.TICE
    rain = torch.where(is_frozen, 0.0, precip)  # [kg/m^2/s]
    snowfall = torch.where(is_frozen, precip, 0.0)
    infil = rain / 1000.0 + melt / dt  # [m/s] of liquid water
    smc = state.smc
    d_if = npdt(cfg.soil_diffusivity) / dz_between
    flux_if = [float(d_if[k]) * (smc[..., k, :, :] - smc[..., k + 1, :, :])
               for k in range(n - 1)]  # [m/s], positive downward
    dsmc = []
    for k in range(n):
        net = torch.zeros_like(t1)
        if k > 0:
            net = net + flux_if[k - 1]
        if k < n - 1:
            net = net - flux_if[k]
        if k == 0:
            net = net + infil - torch.where(has_snow, 0.0, evap) / 1000.0
        dsmc.append(net * dt / float(dzs[k]))
    smc_new = smc + torch.stack(dsmc, dim=-3)
    # runoff: clamp to [smcdry, smcmax] (the excess leaves the column)
    smc_new = torch.clamp(smc_new, cfg.smcdry, cfg.smcmax)

    sublim = torch.where(has_snow, evap, 0.0) * dt / 1000.0  # [m] w.e.
    sneqv_new = torch.clamp(state.sneqv + dt * snowfall / 1000.0 - melt - sublim, min=0.0)

    new_state = LSMState(tskin=ts, stc=stc_new, smc=smc_new, sneqv=sneqv_new)
    fluxes = {
        "shf": shf,
        "lhf": lhf,
        "ground": gflux,
        "net_radiation": rnet,
        "evap": evap,
        "snowmelt": melt / dt,
        # kinematic forms for pbl.py / sas.py
        "sensible_heat_flux": shf / (rho * cp),
        "latent_heat_flux": evap / rho,
    }
    return fluxes, new_state
