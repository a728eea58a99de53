"""SAS-style mass-flux convection, shallow and deep.

Port of ``pace_tpu.models.shield.sas`` (reference role: the GFS SAS of
pySHiELD, Han & Pan 2011). Each (S, Y, X) column is independent; the upward
plume march is a Python loop over k on whole planes. Columns that do not
trigger get a zero cloud-base mass flux, so no column branches. The scheme
transports moist static energy h = cp T + g z + L qv and total water qt =
qv + ql (and the A-grid winds) in flux form with a mass-flux profile that
vanishes at the surface and above cloud top, so the column integrals of h
and qt are conserved; in deep mode the plume's rain leaves the column.

1. parcel source = level of maximum moist static energy in the lowest
   ``src_depth_frac`` of the column by pressure (``torch.argmax`` over a
   ``-inf``-masked column: the first index on ties, as ``jnp.argmax``);
2. entraining updraft marched upward; plume T/qv/ql from a two-step Newton
   saturation solve;
3. cloud base = first saturated plume level; negative-buoyancy work up to
   ``max_cin`` is tolerated while the cloud establishes; then the first
   non-buoyant level is the cloud top;
4. depth gate: at most ``max_depth_pa`` (shallow) or at least
   ``min_depth_pa`` (deep);
5. cloud-base mass flux from the Grant closure (shallow) or the CAPE
   closure (deep), CFL-limited;
6. a parabolic normalized mass-flux profile over the plume layers.

Index convention: k increases downward (k=0 model top), like the dycore.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants
from .mf_common import cbrt, flux_form_divergence, hydrostatic_heights
from .microphysics import d_saturation_mixing_ratio_dt, over, saturation_mixing_ratio


@dataclasses.dataclass(frozen=True)
class ShallowConvectionConfig:
    """Tuning knobs (GFS shalcnv-like defaults), ``pace_tpu``'s fields and
    defaults. ``mode`` selects "shallow" (non-precipitating, Grant closure,
    depth cap) or "deep" (precipitating, CAPE closure, depth floor)."""

    mode: str = "shallow"        #: "shallow" | "deep"
    entrain: float = 2.0e-3      #: fractional entrainment rate [1/m]
    c_m: float = 0.03            #: Grant closure Mb = c_m * rho * w*
    parcel_excess: float = 0.3   #: source-parcel temperature excess [K]
    src_depth_frac: float = 0.7  #: search source below p > frac * ps
    max_depth_pa: float = 3.5e4  #: shallow-only cap on cloud depth [Pa]
    max_subcloud_m: float = 2500.0  #: plume must saturate within this height
    max_cin: float = 25.0        #: negative-buoyancy work the plume survives [J/kg]
    cfl_limit: float = 0.5       #: cap on g*M*dt/dp per layer
    detrain_liquid: bool = True  #: detrained water in cloudy layers -> ql
    mix_momentum: bool = True    #: transport A-grid winds with the plume
    #: convective-momentum-transport reduction (GFS pgcon): the plume wind
    #: is relaxed toward the environment by this fraction
    pgcon: float = 0.55
    #: prescribed kinematic surface fluxes for the closure
    sensible_heat_flux: float = 0.0  #: w'T' [K m/s]
    latent_heat_flux: float = 0.0    #: w'q' [kg/kg m/s]
    #: --- deep mode only:
    min_depth_pa: float = 1.5e4  #: deep gate: cloud at least this thick [Pa]
    rain_conversion: float = 2.0e-3  #: plume ql -> rain per meter of ascent
    c_deep: float = 0.02         #: Mb = c_deep * rho_b * sqrt(2*CAPE)


@dataclasses.dataclass(frozen=True)
class DeepConvectionConfig(ShallowConvectionConfig):
    """SAS deep convection defaults: precipitating entraining plume, CAPE
    closure, weaker entrainment, no shallow depth cap."""

    mode: str = "deep"
    entrain: float = 7.0e-4      #: deep plumes entrain less per meter
    max_depth_pa: float = 1.0e9  #: no cap (gate is the min-depth floor)


def _newton_plume_tq(h_u, qt_u, z, p, t_guess):
    """Plume (T, qv, ql, saturated) from conserved (h, qt) at height z,
    pressure p: two Newton iterations on cp*T + g*z + L*min(qt, qsat(T)) =
    h."""
    cp, lv, g = constants.CP_AIR, constants.HLV, constants.GRAV
    t = t_guess
    for _ in range(2):
        qs = saturation_mixing_ratio(t, p)
        qv = torch.minimum(qt_u, qs)
        sat = qt_u >= qs
        dqsdt = d_saturation_mixing_ratio_dt(t, p, qs)
        resid = h_u - (cp * t + g * z + lv * qv)
        denom = cp + torch.where(sat, lv * dqsdt, 0.0)
        t = t + resid / denom
    qs = saturation_mixing_ratio(t, p)
    qv = torch.minimum(qt_u, qs)
    ql = torch.clamp(qt_u - qv, min=0.0)
    return t, qv, ql, qt_u >= qs


def sas_step(ua, va, t, qv, ql, pe, p_mid, delp, dt: float, cfg: ShallowConvectionConfig,
             sensible_heat_flux=None, latent_heat_flux=None):
    """One SAS step. Layer fields (.., K, Y, X); pe (.., K+1, Y, X).

    Returns (u_dt, v_dt, t_new, qv_new, ql_new, precip): wind tendencies
    (for the caller's A->D projection), the updated thermodynamic fields and
    the surface rain rate [kg/m^2/s] (zero in shallow mode).
    """
    cp, lv, g = constants.CP_AIR, constants.HLV, constants.GRAV
    kax = -3
    K = t.shape[kax]
    shf = cfg.sensible_heat_flux if sensible_heat_flux is None else sensible_heat_flux
    lhf = cfg.latent_heat_flux if latent_heat_flux is None else latent_heat_flux
    deep = cfg.mode == "deep" and cfg.rain_conversion > 0.0

    # -- heights (hydrostatic; condensate loading included in tv)
    tv = t * (1.0 + constants.ZVIR * qv - ql)
    z_mid, z_if, dz = hydrostatic_heights(tv, pe)

    qt = qv + ql
    h = cp * t + g * z_mid + lv * qv
    ps = pe[..., -1, :, :]

    # -- source level: max moist static energy in the lower column
    src_ok = p_mid > cfg.src_depth_frac * ps.unsqueeze(kax)
    h_masked = torch.where(src_ok, h, -torch.inf)
    k_src = torch.argmax(h_masked, dim=kax)  # (.., Y, X)
    levels = torch.arange(K, device=t.device).view(K, 1, 1)
    is_src = levels == k_src.unsqueeze(kax)

    eps_dz = cfg.entrain * dz  # per-layer entrained fraction

    # -- upward plume march (k = K-1 .. 0) over conserved (h_u, qt_u, u, v)
    zc = torch.zeros_like(t[..., 0, :, :])
    fc = torch.zeros_like(zc, dtype=torch.bool)
    h_u, qt_u, u_u, v_u, z_src, work = zc, zc, zc, zc, zc, zc
    started, active, est = fc, fc, fc
    ys = []
    for k in range(K - 1, -1, -1):
        (h_k, qt_k, u_k, v_k, t_k, tv_k, z_k, p_k, dz_k, edz_k, issrc_k) = (
            a[..., k, :, :] for a in (h, qt, ua, va, t, tv, z_mid, p_mid, dz, eps_dz, is_src))
        # entrain environment air over this layer's depth
        f = over(1.0, 1.0 + edz_k)
        h_new = (h_u + edz_k * h_k) * f
        qt_new = (qt_u + edz_k * qt_k) * f
        u_new = (u_u + edz_k * u_k) * f
        v_new = (v_u + edz_k * v_k) * f
        # (re)initialize at the source level
        h_new = torch.where(issrc_k, h_k + constants.CP_AIR * cfg.parcel_excess, h_new)
        qt_new = torch.where(issrc_k, qt_k, qt_new)
        u_new = torch.where(issrc_k, u_k, u_new)
        v_new = torch.where(issrc_k, v_k, v_new)
        z_src = torch.where(issrc_k, z_k, z_src)
        work = torch.where(issrc_k, 0.0, work)
        est = est & ~issrc_k
        started = started | issrc_k
        active = (active | issrc_k) & started
        # diagnose plume state and buoyancy at this level
        t_u, qv_u, ql_u, sat = _newton_plume_tq(h_new, qt_new, z_k, p_k, t_k)
        tv_u = t_u * (1.0 + constants.ZVIR * qv_u - ql_u)
        buoyant = tv_u > tv_k
        # accumulate negative-buoyancy work; the plume survives CIN up to
        # cfg.max_cin below cloud base
        work = work + torch.clamp(tv_k - tv_u, min=0.0) / tv_k * constants.GRAV * dz_k
        too_dry = (~sat) & (z_k - z_src > cfg.max_subcloud_m)
        # once a buoyant saturated level exists, the first non-buoyant level
        # is the cloud top (kept as the overshoot layer)
        top_hit = est & sat & ~buoyant & active
        active = active & (work <= cfg.max_cin) & ~too_dry & (qt_new > 0.0) & ~top_hit
        in_plume = (active | issrc_k | top_hit) & started
        est = est | (in_plume & sat & buoyant)
        # deep mode: plume condensate converts to rain along the ascent
        if deep:
            rain_k = torch.where(in_plume & sat,
                                 ql_u * torch.clamp(cfg.rain_conversion * dz_k, 0.0, 1.0), 0.0)
            qt_new = qt_new - rain_k
            ql_u = ql_u - rain_k
        else:
            rain_k = torch.zeros_like(qt_new)
        h_u, qt_u, u_u, v_u = h_new, qt_new, u_new, v_new
        ys.append((h_new, qt_new, u_new, v_new, t_u, qv_u, ql_u, in_plume & sat, in_plume,
                   in_plume & sat & buoyant, rain_k))
    (h_u, qt_u, u_u, v_u, t_u, qv_u, ql_u, cloudy, in_plume, cld_buoy,
     rain_u) = (torch.stack(a[::-1], dim=kax) for a in zip(*ys))

    # -- depth gate + a buoyant cloud (>= 1 saturated level positively
    # buoyant): shallow mode caps the depth, deep mode sets a floor
    cloudy_f = cloudy.to(t.dtype)
    p_base = torch.amax(torch.where(cloudy, p_mid, -torch.inf), dim=kax)
    p_top = torch.amin(torch.where(cloudy, p_mid, torch.inf), dim=kax)
    has_cloud = torch.any(cld_buoy, dim=kax)
    depth = torch.where(has_cloud, p_base - p_top, 0.0)
    if cfg.mode == "deep":
        gate = has_cloud & (depth >= cfg.min_depth_pa)
    else:
        gate = has_cloud & (depth <= cfg.max_depth_pa)

    # -- Grant closure: w* from the surface buoyancy flux and the plume-base
    # height (the lowest cloudy level)
    thv1 = tv[..., -1, :, :] * over(constants.P_REF, p_mid[..., -1, :, :]) ** constants.KAPPA
    wthv = shf * (1.0 + constants.ZVIR * qv[..., -1, :, :]) \
        + constants.ZVIR * t[..., -1, :, :] * lhf
    z_base = torch.amin(torch.where(cloudy, z_mid, torch.inf), dim=kax)
    z_base = torch.where(has_cloud, z_base, 0.0)
    wstar = cbrt(torch.clamp(over(g, thv1) * wthv * torch.clamp(z_base, min=1.0), min=0.0))
    rho_b = p_base / (constants.RDGAS * torch.clamp(
        torch.sum(tv * cloudy_f, dim=kax)
        / torch.clamp(torch.sum(cloudy_f, dim=kax), min=1.0), min=100.0))
    if cfg.mode == "deep":
        # CAPE closure: Mb = c_deep * rho_b * sqrt(2*CAPE) over the buoyant
        # plume layers
        tv_plume = torch.where(in_plume, t_u * (1.0 + constants.ZVIR * qv_u - ql_u), tv)
        buoy_acc = torch.clamp(tv_plume - tv, min=0.0) / tv
        cape = torch.sum(g * buoy_acc * dz * in_plume.to(t.dtype), dim=kax)
        mb = torch.where(gate, cfg.c_deep * rho_b * torch.sqrt(2.0 * cape), 0.0)
    else:
        mb = torch.where(gate, cfg.c_m * rho_b * wstar, 0.0)

    # CFL cap: g * M * dt / dp <= cfl_limit over every plume layer
    plume_f = in_plume.to(t.dtype)
    dp_min = torch.amin(torch.where(in_plume, delp, torch.inf), dim=kax)
    mb = torch.minimum(mb, cfg.cfl_limit * dp_min / (g * dt))

    # -- parabolic normalized mass-flux profile on the K+1 interfaces, zero
    # at both plume ends
    csum = torch.cumsum(plume_f, dim=kax)  # plume layers with index <= k
    total = csum[..., -1:, :, :]
    zero = torch.zeros_like(total)
    above_if = torch.cat([zero, csum], dim=kax)
    below_if = total - above_if
    shape_if = 4.0 * above_if * below_if / torch.clamp(total, min=1.0) ** 2
    m_if = mb.unsqueeze(kax) * shape_if  # [kg/m^2/s], upward

    def flux_div(x_u, x_env):
        return flux_form_divergence(m_if, x_u, x_env, delp)

    # plume values outside the plume are the environment's (M is zero there)
    def sel(p_val, env):
        return torch.where(in_plume, p_val, env)

    dh = dt * flux_div(sel(h_u, h), h)
    dqt = dt * flux_div(sel(qt_u, qt), qt)

    # -- deep mode: the plume's rain leaves the column
    m_top = m_if[..., :-1, :, :]  # flux through each layer's top interface
    rain_sink = m_top * torch.where(in_plume, rain_u, 0.0)  # [kg/m^2/s]
    precip = torch.sum(rain_sink, dim=kax)  # surface rain rate [kg/m^2/s]
    dqt = dqt - dt * g * rain_sink / delp

    # -- recover (T, qv, ql): detrained water in cloudy layers becomes cloud
    # liquid; h-conservation fixes the temperature: cp*dT = dh - L*dqv
    if cfg.detrain_liquid:
        dql = torch.where(cloudy, torch.clamp(dqt, min=0.0)
                          * (sel(ql_u, 0.0) / torch.clamp(sel(qt_u, 1.0), min=1e-12)), 0.0)
    else:
        dql = torch.zeros_like(dqt)
    dqv = dqt - dql
    # never drive qv/ql negative: shift any overdraft between the phases
    dqv_def = torch.clamp(-(qv + dqv), min=0.0)
    dqv, dql = dqv + dqv_def, dql - dqv_def
    dql_def = torch.clamp(-(ql + dql), min=0.0)
    dql, dqv = dql + dql_def, dqv - dql_def
    t_new = t + (dh - lv * dqv) / cp
    qv_new = qv + dqv
    ql_new = ql + dql

    if cfg.mix_momentum:
        # pgcon: plume momentum partly equilibrated with the environment
        u_mix = sel(u_u, ua) * (1.0 - cfg.pgcon) + ua * cfg.pgcon
        v_mix = sel(v_u, va) * (1.0 - cfg.pgcon) + va * cfg.pgcon
        u_dt = flux_div(u_mix, ua)
        v_dt = flux_div(v_mix, va)
    else:
        u_dt = torch.zeros_like(ua)
        v_dt = torch.zeros_like(va)
    return u_dt, v_dt, t_new, qv_new, ql_new, precip
