"""GFDL single-moment 6-category cloud microphysics (column-local, branchless).

Port of ``pace_tpu.models.shield.microphysics`` (reference role:
``pySHiELD/stencils/microphysics.py``, the GFDL cloud microphysics of Lin et
al. 1983 / Chen & Lin 2013 lineage: vapor, cloud water, cloud ice, rain,
snow and graupel). The same processes, in the same order, on tensors of the
shape ``pace_tpu`` takes (k at axis -3), on their device with their dtype:

- the fast phase adjustment (:func:`fast_saturation_adjustment`), shared
  with the dycore's ``do_sat_adj`` stage: condensation and evaporation,
  homogeneous and Bigg freezing, ice melt, deposition and sublimation, the
  Wegener-Bergeron-Findeisen transfer and the diagnostic cloud fraction;
- warm rain (:func:`warm_rain_processes`): autoconversion, accretion, rain
  evaporation;
- the cold processes (:func:`cold_processes`): riming, collection,
  autoconversions, rain freezing, snow and graupel melt, sublimation and
  deposition;
- sedimentation (:func:`terminal_fall`): a fall-speed law per species and an
  implicit upwind fall down each column, a Python loop over k on whole
  (S, Y, X) planes where ``pace_tpu`` scans;
- time sub-cycling: ``ntimes = ceil(dt / mp_time)`` (or ``dt_split``), a
  Python loop.

Water and moist enthalpy ``cp T + Lv qv - Lf (qi + qs + qg)`` are conserved
by every process except ``do_sedi_heat``, up to the precipitation that
leaves through the surface. Plain PyTorch throughout: ``pace_tpu`` leaves
this module to XLA and has no kernel of its own here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ... import constants

T_FREEZE = 273.16          #: tice
T_WFR = T_FREEZE - 40.0    #: homogeneous freezing of cloud water
QMIN = 1.0e-12             #: tracer floor used in rate denominators
RHO_SFC = 1.2              #: reference surface air density [kg/m^3]


@dataclasses.dataclass(frozen=True)
class MicrophysicsConfig:
    """Namelist surface: ``pace_tpu``'s fields and defaults (the GFDL-MP
    keys of the reference's example configs)."""

    # --- structural switches
    do_sedimentation: bool = True
    do_warm_rain: bool = True
    do_ice: bool = True
    #: explicit sub-step count override; 0/1 = derive from mp_time
    dt_split: int = 1
    #: max sub-step length [s] (reference mp_time); dt <= mp_time runs once
    mp_time: float = 150.0

    # --- fast adjustment taus [s] (reference tau_* family)
    tau_l2v: float = 300.0   #: cloud water evaporation
    tau_v2l: float = 150.0   #: condensation
    tau_imlt: float = 600.0  #: cloud ice melt
    tau_smlt: float = 900.0  #: snow melt
    tau_i2s: float = 1000.0  #: ice -> snow autoconversion
    tau_g2v: float = 1200.0  #: graupel sublimation
    tau_v2g: float = 21600.0 #: graupel deposition (slow)

    # --- generation caps / thresholds [kg/kg unless noted]
    ql_gen: float = 1.0e-3   #: max cloud water generation per call
    ql_mlt: float = 2.0e-3   #: max cloud water retained from ice melt
    qs_mlt: float = 1.0e-6   #: max cloud water retained from snow melt
    qi_lim: float = 1.0      #: ice generation limit factor
    qi0_crt: float = 1.0e-4  #: ice -> snow autoconversion threshold [kg/m^3]
    qs0_crt: float = 1.0e-3  #: snow -> graupel threshold [kg/m^3]
    ql0_max: float = 2.0e-3  #: liquid -> rain autoconversion threshold

    # --- rate coefficients (Lin83-lineage bulk collection efficiencies)
    c_paut: float = 0.55     #: autoconversion scale
    c_cracw: float = 0.8     #: rain accreting cloud water
    c_psacw: float = 1.0     #: snow accreting cloud water (riming)
    c_pgacw: float = 1.0     #: graupel accreting cloud water (riming)
    c_psaci: float = 0.02    #: snow accreting cloud ice
    c_pgaci: float = 0.05    #: graupel accreting cloud ice
    c_pgfr: float = 20.0     #: Bigg rain-freezing scale
    tau_auto: float = 1800.0 #: warm-rain autoconversion timescale [s]
    tau_revp: float = 600.0  #: rain re-evaporation timescale [s]

    # --- subgrid humidity variability (cloud fraction + auto threshold)
    dw_ocean: float = 0.10
    dw_land: float = 0.20
    icloud_f: int = 0        #: cloud-fraction scheme selector (0/1)
    do_qa: bool = True       #: diagnose cloud fraction

    # --- fall speeds: q_den power laws  v = fac*c*(rho q / norm)^b * rhof
    vi_fac: float = 1.0
    vr_fac: float = 1.0
    vs_fac: float = 1.0
    vg_fac: float = 1.0
    vi_max: float = 0.5      #: [m/s] caps
    vr_max: float = 12.0
    vs_max: float = 5.0
    vg_max: float = 8.0
    const_vi: bool = False   #: use vX_fac as a constant speed instead
    const_vr: bool = False
    const_vs: bool = False
    const_vg: bool = False
    do_sedi_heat: bool = False

    # --- temperature guards
    t_min: float = 178.0     #: no sublimation products below this
    t_sub: float = 184.0     #: min temperature for sublimation


def over(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as a true division, as ``pace_tpu``'s is: PyTorch computes a
    Python number over a tensor as the tensor's reciprocal times the number.
    The numerator is a 0-dim CPU tensor, which PyTorch takes as a scalar for
    a tensor on any device."""
    return torch.tensor(c, dtype=x.dtype) / x


def _where0(cond, x):
    """``x`` where ``cond``, else 0."""
    return torch.where(cond, x, 0.0)


# ----------------------------------------------------------------------
# saturation thermodynamics (shared by SAS / PBL / the dycore)
# ----------------------------------------------------------------------

def saturation_vapor_pressure(t):
    """Flatau-style liquid saturation vapor pressure [Pa] (clipped)."""
    tc = torch.clamp(t - T_FREEZE, -80.0, 50.0)
    return 611.21 * torch.exp(17.502 * tc / (tc + 240.97))


def saturation_vapor_pressure_ice(t):
    """Saturation vapor pressure over ice [Pa] (Buck-style fit; above
    freezing it equals the value at freezing)."""
    tc = torch.clamp(t - T_FREEZE, -80.0, 0.0)
    return 611.15 * torch.exp(22.452 * tc / (tc + 272.55))


def saturation_mixing_ratio(t, p):
    es = saturation_vapor_pressure(t)
    eps = constants.RDGAS / constants.RVGAS
    return eps * es / torch.clamp(p - es, min=1.0)


def saturation_mixing_ratio_ice(t, p):
    es = saturation_vapor_pressure_ice(t)
    eps = constants.RDGAS / constants.RVGAS
    return eps * es / torch.clamp(p - es, min=1.0)


def d_saturation_mixing_ratio_dt(t, p, qsat=None):
    """Clausius-Clapeyron derivative d(qsat)/dT of the fit above, the one
    linearization every Newton step of the physics uses."""
    if qsat is None:
        qsat = saturation_mixing_ratio(t, p)
    tc = torch.clamp(t - T_FREEZE, -80.0, 50.0)
    return qsat * 17.502 * 240.97 / (tc + 240.97) ** 2


def d_saturation_mixing_ratio_ice_dt(t, p, qsat=None):
    if qsat is None:
        qsat = saturation_mixing_ratio_ice(t, p)
    tc = torch.clamp(t - T_FREEZE, -80.0, 0.0)
    return qsat * 22.452 * 272.55 / (tc + 272.55) ** 2


def _frac(dt: float, tau: float) -> float:
    """Relaxation fraction 1 - exp(-dt/tau), the branchless stable form of
    min(dt/tau, 1)."""
    return 1.0 - math.exp(-dt / tau)


def _dw(cfg: MicrophysicsConfig, land, t):
    """The subgrid humidity half-width: dw_ocean, or blended by the land
    fraction ``land`` (.., Y, X) or (.., K, Y, X)."""
    if land is None:
        return cfg.dw_ocean
    dw = cfg.dw_ocean + (cfg.dw_land - cfg.dw_ocean) * land
    return dw.unsqueeze(-3) if dw.ndim == t.ndim - 1 else dw


# ----------------------------------------------------------------------
# fast phase adjustment (shared with the dycore sat_adj stage)
# ----------------------------------------------------------------------

def fast_saturation_adjustment(qv, ql, qi, qr, qs, qg, t, p, dt,
                               config: MicrophysicsConfig | None = None,
                               land=None):
    """All-species fast phase adjustment (reference SatAdjust3d, shared
    between the dycore's ``do_sat_adj`` and the microphysics).

    Returns (qv, ql, qi, qr, qs, qg, t, qa); qa is None unless
    ``config.do_qa``. Moist enthalpy and total water are conserved.
    ``land``: optional land fraction for the dw_land/dw_ocean width.
    """
    cfg = config if config is not None else MicrophysicsConfig()
    lv = constants.HLV
    lf = constants.HLF
    ls = lv + lf
    cp = constants.CP_AIR

    # --- 1. condensation / evaporation qv <-> ql, one Newton step
    qsw = saturation_mixing_ratio(t, p)
    dqdt = d_saturation_mixing_ratio_dt(t, p, qsw)
    excess = (qv - qsw) / (1.0 + (lv / cp) * dqdt)
    cond = torch.clamp(torch.clamp(excess, min=0.0) * _frac(dt, cfg.tau_v2l), max=cfg.ql_gen)
    evap = torch.minimum(torch.clamp(-excess, min=0.0) * _frac(dt, cfg.tau_l2v), ql)
    dq = cond - evap
    qv, ql, t = qv - dq, ql + dq, t + (lv / cp) * dq

    # --- 2. freezing of cloud water: instant below t_wfr, Bigg-style
    # gradual in (t_wfr, tice)
    supercool = torch.clamp(T_FREEZE - t, 0.0, 40.0)
    bigg = _frac(dt, 3600.0) * (torch.exp(0.66 * supercool * 0.25) - 1.0)
    frz_frac = torch.where(t < T_WFR, 1.0, torch.clamp(bigg, 0.0, 1.0))
    freeze = ql * frz_frac
    ql, qi, t = ql - freeze, qi + freeze, t + (lf / cp) * freeze

    # --- 3. cloud ice melt above freezing: up to ql_mlt stays cloud water,
    # the rest rains out
    melt = _where0(t > T_FREEZE, qi * _frac(dt, cfg.tau_imlt))
    melt = torch.minimum(melt, torch.clamp(t - T_FREEZE, min=0.0) * cp / lf)
    to_l = torch.minimum(melt, torch.clamp(cfg.ql_mlt - ql, min=0.0))
    qi = qi - melt
    ql = ql + to_l
    qr = qr + (melt - to_l)
    t = t - (lf / cp) * melt

    # --- 4. deposition / sublimation qv <-> qi below freezing
    qsi = saturation_mixing_ratio_ice(t, p)
    dqidt = d_saturation_mixing_ratio_ice_dt(t, p, qsi)
    exi = (qv - qsi) / (1.0 + (ls / cp) * dqidt)
    cold = t < T_FREEZE
    cap = cfg.qi_lim * 1.0e-3 * torch.clamp((T_FREEZE - t) / 40.0, 0.0, 1.0)
    dep = _where0(cold, torch.minimum(torch.clamp(exi, min=0.0) * _frac(dt, cfg.tau_v2l), cap))
    sub = _where0(cold & (t > cfg.t_sub),
                  torch.minimum(torch.clamp(-exi, min=0.0) * _frac(dt, cfg.tau_l2v), qi))
    dqi = dep - sub
    qv, qi, t = qv - dqi, qi + dqi, t + (ls / cp) * dqi

    # --- 5. Wegener-Bergeron-Findeisen: the qsw-qsi gap grows ice at the
    # liquid's expense where both coexist below freezing
    wbf_rate = _where0(cold & (qi > QMIN) & (ql > QMIN),
                       torch.clamp((qsw - qsi) / torch.clamp(qsi, min=QMIN), 0.0, 1.0))
    wbf = torch.minimum(ql * wbf_rate * _frac(dt, 600.0), ql)
    ql, qi, t = ql - wbf, qi + wbf, t + (lf / cp) * wbf

    # --- 6. diagnostic cloud fraction (do_qa; icloud_f selects the law)
    qa = None
    if cfg.do_qa:
        dw = _dw(cfg, land, t)
        qsm = torch.where(cold, qsi, qsw)
        rh = (qv + ql + qi) / torch.clamp(qsm, min=QMIN)
        if cfg.icloud_f == 1:
            qa = torch.clamp((rh - (1.0 - 0.5 * dw)) / (0.5 * dw), 0.0, 1.0)
        else:
            qa = torch.clamp((rh - (1.0 - dw)) / dw, 0.0, 1.0)
        qa = torch.where(ql + qi > QMIN, torch.clamp(qa, min=0.05), qa)

    return qv, ql, qi, qr, qs, qg, t, qa


# ----------------------------------------------------------------------
# warm rain
# ----------------------------------------------------------------------

def warm_rain_processes(qv, ql, qr, t, p, dt, cfg: MicrophysicsConfig, land=None):
    """Autoconversion, accretion, rain evaporation. Conserves water and
    moist enthalpy."""
    lv = constants.HLV
    cp = constants.CP_AIR
    rho = p / (constants.RDGAS * torch.clamp(t, min=100.0))

    # autoconversion above the dw-lowered threshold
    dw = _dw(cfg, land, t)
    ql_crit = cfg.ql0_max * (1.0 - 0.5 * dw)
    auto = cfg.c_paut * torch.clamp(ql - ql_crit, min=0.0) * _frac(dt, cfg.tau_auto)

    # accretion: rain collecting cloud water, ql (rho qr)^0.875
    qden = torch.clamp(rho * qr, min=0.0)
    accr = (cfg.c_cracw * ql * qden ** 0.875
            * torch.sqrt(torch.clamp(over(RHO_SFC, rho), max=10.0)) * dt / 20.0)
    to_rain = torch.minimum(auto + accr, ql)
    ql = ql - to_rain
    qr = qr + to_rain

    # rain evaporation toward saturation in subsaturated air
    qsw = saturation_mixing_ratio(t, p)
    dqdt = d_saturation_mixing_ratio_dt(t, p, qsw)
    subsat = torch.clamp(qsw - qv, min=0.0) / (1.0 + (lv / cp) * dqdt)
    evap = torch.minimum(qr * _frac(dt, cfg.tau_revp), subsat)
    qr = qr - evap
    qv = qv + evap
    t = t - (lv / cp) * evap
    return qv, ql, qr, t


# ----------------------------------------------------------------------
# cold (ice-phase) processes
# ----------------------------------------------------------------------

def cold_processes(qv, ql, qi, qr, qs, qg, t, p, dt, cfg: MicrophysicsConfig):
    """The reference "icloud" block: riming, collection, autoconversions,
    rain freezing, snow/graupel melt, snow/graupel sublimation-deposition.
    Conserves water and moist enthalpy."""
    lv = constants.HLV
    lf = constants.HLF
    ls = lv + lf
    cp = constants.CP_AIR
    rho = p / (constants.RDGAS * torch.clamp(t, min=100.0))
    rhof = torch.sqrt(torch.clamp(over(RHO_SFC, rho), max=10.0))
    cold = t < T_FREEZE
    warm = ~cold

    # --- riming: snow collecting cloud water (psacw); frozen below
    # freezing, shed to rain above
    k_sacw = cfg.c_psacw * (torch.clamp(rho * qs, min=0.0) ** 0.8125) * rhof
    psacw = torch.minimum(ql * k_sacw * dt / 10.0, ql)
    ql = ql - psacw
    qs = qs + _where0(cold, psacw)
    qr = qr + _where0(warm, psacw)
    t = t + _where0(cold, (lf / cp) * psacw)

    # --- riming: graupel collecting cloud water (pgacw)
    k_gacw = cfg.c_pgacw * (torch.clamp(rho * qg, min=0.0) ** 0.875) * rhof
    pgacw = torch.minimum(ql * k_gacw * dt / 10.0, ql)
    ql = ql - pgacw
    qg = qg + _where0(cold, pgacw)
    qr = qr + _where0(warm, pgacw)
    t = t + _where0(cold, (lf / cp) * pgacw)

    # --- snow collecting cloud ice (psaci)
    k_saci = cfg.c_psaci * (torch.clamp(rho * qs, min=0.0) ** 0.8125) * rhof
    psaci = torch.minimum(qi * k_saci * dt, qi)
    qi = qi - psaci
    qs = qs + psaci

    # --- graupel collecting cloud ice (pgaci)
    k_gaci = cfg.c_pgaci * (torch.clamp(rho * qg, min=0.0) ** 0.875) * rhof
    pgaci = torch.minimum(qi * k_gaci * dt, qi)
    qi = qi - pgaci
    qg = qg + pgaci

    # --- autoconversion ice -> snow above the density threshold qi0_crt
    qi_crt = over(cfg.qi0_crt * cfg.qi_lim, torch.clamp(rho, min=0.1))
    psaut = torch.clamp(qi - qi_crt, min=0.0) * _frac(dt, cfg.tau_i2s)
    psaut = _where0(cold, torch.minimum(psaut, qi))
    qi = qi - psaut
    qs = qs + psaut

    # --- autoconversion snow -> graupel above qs0_crt
    qs_crt = over(cfg.qs0_crt, torch.clamp(rho, min=0.1))
    pgaut = _where0(cold, torch.minimum(torch.clamp(qs - qs_crt, min=0.0) * _frac(dt, 1800.0),
                                        qs))
    qs = qs - pgaut
    qg = qg + pgaut

    # --- rain freezing to graupel (Bigg immersion freezing, pgfr)
    supercool = torch.clamp(T_FREEZE - t, 0.0, 40.0)
    k_gfr = cfg.c_pgfr * (torch.exp(0.66 * supercool * 0.125) - 1.0) / 86400.0
    pgfr = torch.minimum(qr * torch.clamp(k_gfr * dt, 0.0, 1.0), qr)
    qr = qr - pgfr
    qg = qg + pgfr
    t = t + (lf / cp) * pgfr

    # --- snow melt above freezing: up to qs_mlt stays cloud water
    smlt = _where0(warm, qs * _frac(dt, cfg.tau_smlt))
    smlt = torch.minimum(smlt, torch.clamp(t - T_FREEZE, min=0.0) * cp / lf)
    to_l = torch.minimum(smlt, torch.clamp(cfg.qs_mlt - ql, min=0.0))
    qs = qs - smlt
    ql = ql + to_l
    qr = qr + (smlt - to_l)
    t = t - (lf / cp) * smlt

    # --- graupel melt above freezing -> rain
    gmlt = _where0(warm, qg * _frac(dt, cfg.tau_smlt))
    gmlt = torch.minimum(gmlt, torch.clamp(t - T_FREEZE, min=0.0) * cp / lf)
    qg = qg - gmlt
    qr = qr + gmlt
    t = t - (lf / cp) * gmlt

    # --- snow & graupel sublimation / deposition wrt ice below freezing
    qsi = saturation_mixing_ratio_ice(t, p)
    dqidt = d_saturation_mixing_ratio_ice_dt(t, p, qsi)
    exi = (qv - qsi) / (1.0 + (ls / cp) * dqidt)
    can_sub = cold & (t > cfg.t_sub)
    pssub = _where0(can_sub,
                    torch.minimum(torch.clamp(-exi, min=0.0) * _frac(dt, cfg.tau_g2v), qs))
    qs = qs - pssub
    qv = qv + pssub
    t = t - (ls / cp) * pssub
    # the gap after the snow term, so that the pair cannot overshoot
    exi2 = exi + pssub
    pgsub = _where0(can_sub,
                    torch.minimum(torch.clamp(-exi2, min=0.0) * _frac(dt, cfg.tau_g2v), qg))
    pgdep = _where0(cold & (qg > QMIN), torch.clamp(exi2, min=0.0) * _frac(dt, cfg.tau_v2g))
    pgdep = torch.minimum(pgdep, torch.clamp(qv, min=0.0))
    dqg = pgdep - pgsub
    qg = qg + dqg
    qv = qv - dqg
    t = t + (ls / cp) * dqg

    return qv, ql, qi, qr, qs, qg, t


# ----------------------------------------------------------------------
# sedimentation
# ----------------------------------------------------------------------

#: Lin83 Marshall-Palmer normalizations pi * rho_species * N0_species
_NORM_RAIN = math.pi * 1000.0 * 8.0e6      # rho_w=1000, N0r=8e6
_NORM_SNOW = math.pi * 100.0 * 3.0e6       # rho_s=100,  N0s=3e6
_NORM_GRAUPEL = math.pi * 400.0 * 4.0e6    # rho_g=400,  N0g=4e6


def _power_law_speed(q, rho, coeff, norm, expo):
    """Mass-weighted Marshall-Palmer fall speed coeff*(rho q/norm)^expo with
    the sqrt(rho_sfc/rho) air-density correction."""
    qden = torch.clamp(rho * q, min=QMIN * RHO_SFC)
    rhof = torch.sqrt(torch.clamp(over(RHO_SFC, rho), max=10.0))
    return coeff * torch.exp(expo * torch.log(qden / norm)) * rhof


def fall_speed_rain(q, rho, cfg: MicrophysicsConfig):
    """Lin83 rain: 2503.23 (rho q / pi rho_w N0r)^0.2."""
    if cfg.const_vr:
        return torch.full_like(q, cfg.vr_fac)
    v = _power_law_speed(q, rho, 2503.23, _NORM_RAIN, 0.2)
    return torch.clamp(cfg.vr_fac * v, 0.0, cfg.vr_max)


def fall_speed_snow(q, rho, cfg: MicrophysicsConfig):
    """Lin83 snow: 6.63 (rho q / pi rho_s N0s)^0.0625."""
    if cfg.const_vs:
        return torch.full_like(q, cfg.vs_fac)
    v = _power_law_speed(q, rho, 6.63, _NORM_SNOW, 0.0625)
    return torch.clamp(cfg.vs_fac * v, 0.0, cfg.vs_max)


def fall_speed_graupel(q, rho, cfg: MicrophysicsConfig):
    """Lin83 graupel: 87.2 (rho q / pi rho_g N0g)^0.125."""
    if cfg.const_vg:
        return torch.full_like(q, cfg.vg_fac)
    v = _power_law_speed(q, rho, 87.2, _NORM_GRAUPEL, 0.125)
    return torch.clamp(cfg.vg_fac * v, 0.0, cfg.vg_max)


def fall_speed_ice(q, rho, cfg: MicrophysicsConfig):
    """Heymsfield-Donner 1990 cloud-ice fall speed 3.29 (rho qi)^0.16."""
    if cfg.const_vi:
        return torch.full_like(q, cfg.vi_fac)
    v = 3.29 * torch.clamp(rho * q, min=0.0) ** 0.16
    return torch.clamp(cfg.vi_fac * v, 0.0, cfg.vi_max)


def _sediment(q, delp, vfall, t, p, dt):
    """Implicit upwind sedimentation down the column (conservative).

    The flux out of layer k feeds layer k+1; the implicit weighting keeps it
    stable at any Courant number. A Python loop over k on whole (S, Y, X)
    planes, each level's operations in ``pace_tpu``'s order. Returns (q_new,
    surface_precip [kg/m^2]).
    """
    rho = p / (constants.RDGAS * torch.clamp(t, min=100.0))
    dz = delp / (rho * constants.GRAV)  # layer geometric thickness [m]
    cr = vfall * dt / torch.clamp(dz, min=1.0)  # courant number
    cr = torch.broadcast_to(cr, q.shape)
    flux = torch.zeros_like(q[..., 0, :, :])
    levels = []
    for k in range(q.shape[-3]):
        dpk, crk = delp[..., k, :, :], cr[..., k, :, :]
        # implicit: q_new = (q + flux_in/dp) / (1 + cr)
        qn = (q[..., k, :, :] + flux / dpk) / (1.0 + crk)
        flux = qn * crk * dpk
        levels.append(qn)
    return torch.stack(levels, dim=-3), flux / constants.GRAV


def _sedi_heat(q_before, q_after, t, delp, c_species):
    """Sedimentation heat transport: layers that receive condensate relax
    toward the mass-weighted column mean temperature of the falling species
    (column-conserving, do_sedi_heat)."""
    cp = constants.CP_AIR
    dq = q_after - q_before
    w = torch.clamp(q_before, min=QMIN) * delp
    t_src = torch.sum(t * w, dim=-3, keepdim=True) / torch.sum(w, dim=-3, keepdim=True)
    return t + dq * c_species * (t_src - t) / cp


def terminal_fall(qi, qr, qs, qg, t, p, delp, dt, cfg: MicrophysicsConfig):
    """Sediment all falling species with their fall-speed laws. Returns
    updated (qi, qr, qs, qg, t) and per-species surface precip [kg/m^2]."""
    rho = p / (constants.RDGAS * torch.clamp(t, min=100.0))
    qr0, qs0, qg0 = qr, qs, qg
    qr, pr = _sediment(qr, delp, fall_speed_rain(qr, rho, cfg), t, p, dt)
    qs, ps_ = _sediment(qs, delp, fall_speed_snow(qs, rho, cfg), t, p, dt)
    qg, pg = _sediment(qg, delp, fall_speed_graupel(qg, rho, cfg), t, p, dt)
    qi, pi_ = _sediment(qi, delp, fall_speed_ice(qi, rho, cfg), t, p, dt)
    if cfg.do_sedi_heat:
        c_liq, c_ice = 4185.5, 1972.0
        t = _sedi_heat(qr0, qr, t, delp, c_liq)
        t = _sedi_heat(qs0, qs, t, delp, c_ice)
        t = _sedi_heat(qg0, qg, t, delp, c_ice)
    return qi, qr, qs, qg, t, (pr, pi_, ps_, pg)


# ----------------------------------------------------------------------
# the whole step
# ----------------------------------------------------------------------

def microphysics_step(qv, ql, qi, qr, qs, qg, t, p, delp, dt, config=None, land=None):
    """One full microphysics step on layer tensors (.., K, Y, X).

    ``t`` is temperature [K], ``p`` layer pressure [Pa]. Sub-cycling:
    ntimes = cfg.dt_split if > 1 else ceil(dt / cfg.mp_time). Returns
    updated (qv, ql, qi, qr, qs, qg, t, precip), ``precip`` the total
    surface condensate [kg/m^2] over the step.
    """
    cfg = config if config is not None else MicrophysicsConfig()
    ntimes = (
        int(cfg.dt_split)
        if int(cfg.dt_split) > 1
        else max(1, int(-(-dt // max(cfg.mp_time, 1.0))))
    )
    dts = dt / ntimes

    precip = torch.zeros_like(t[..., 0, :, :])
    for _ in range(ntimes):
        if cfg.do_ice:
            qv, ql, qi, qr, qs, qg, t, _qa = fast_saturation_adjustment(
                qv, ql, qi, qr, qs, qg, t, p, dts, cfg, land)
        else:
            qv, ql, qi, qr, qs, qg, t, _qa = _warm_only_adjust(
                qv, ql, qi, qr, qs, qg, t, p, dts, cfg)
        if cfg.do_warm_rain:
            qv, ql, qr, t = warm_rain_processes(qv, ql, qr, t, p, dts, cfg, land)
        if cfg.do_ice:
            qv, ql, qi, qr, qs, qg, t = cold_processes(qv, ql, qi, qr, qs, qg, t, p, dts, cfg)
        if cfg.do_sedimentation:
            qi, qr, qs, qg, t, (pr, pi_, ps_, pg) = terminal_fall(
                qi, qr, qs, qg, t, p, delp, dts, cfg)
            precip = precip + pr + pi_ + ps_ + pg

    return qv, ql, qi, qr, qs, qg, t, precip


def _warm_only_adjust(qv, ql, qi, qr, qs, qg, t, p, dt, cfg: MicrophysicsConfig):
    """do_ice=False: qv<->ql condensation/evaporation only."""
    lv = constants.HLV
    cp = constants.CP_AIR
    qsw = saturation_mixing_ratio(t, p)
    dqdt = d_saturation_mixing_ratio_dt(t, p, qsw)
    excess = (qv - qsw) / (1.0 + (lv / cp) * dqdt)
    cond = torch.clamp(torch.clamp(excess, min=0.0) * _frac(dt, cfg.tau_v2l), max=cfg.ql_gen)
    evap = torch.minimum(torch.clamp(-excess, min=0.0) * _frac(dt, cfg.tau_l2v), ql)
    dq = cond - evap
    return qv - dq, ql + dq, qi, qr, qs, qg, t + (lv / cp) * dq, None
