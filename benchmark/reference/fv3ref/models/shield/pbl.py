"""EDMF planetary-boundary-layer scheme (eddy-diffusivity mass-flux).

Port of ``pace_tpu.models.shield.pbl`` (reference role: the GFS EDMF PBL of
pySHiELD):

- a K-profile (Troen-Mahrt / Han-Pan form) inside the boundary layer, whose
  top is the lowest level of bulk Richardson number above ``ricr``, found
  with a reversed cumulative product of a 0/1 mask;
- local Louis-type mixing above it;
- backward-Euler implicit vertical diffusion of the A-grid winds, the dry
  static energy and vapor, with an implicit surface drag; the Thomas
  algorithm's two sweeps are Python loops over k on whole (S, Y, X) planes;
- a single entraining updraft (Siebesma et al. 2007) under convective
  conditions, marched bottom-up as a Python loop over k, transporting s and
  qv through the conservative flux form of ``mf_common``.

Index convention: k increases downward (k=0 model top), like the dycore.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants
from .mf_common import cbrt, flux_form_divergence, hydrostatic_heights
from .microphysics import over


@dataclasses.dataclass(frozen=True)
class PBLConfig:
    """Tuning knobs (GFS-like defaults): ``pace_tpu``'s fields and
    defaults."""

    karman: float = 0.4
    ricr: float = 0.25        #: bulk-Ri PBL-top criterion
    z0: float = 0.01          #: surface roughness length [m] (ocean-ish)
    l0: float = 150.0         #: asymptotic mixing length [m]
    k_max: float = 300.0      #: ceiling on eddy diffusivity [m^2/s]
    k_background: float = 0.01  #: floor (free troposphere) [m^2/s]
    prandtl: float = 1.0      #: K_m / K_h
    #: prescribed kinematic surface fluxes (idealized runs have no LSM):
    sensible_heat_flux: float = 0.0  #: w'T' [K m/s]
    latent_heat_flux: float = 0.0    #: w'q' [kg/kg m/s]
    #: --- EDMF mass-flux component (active only under a positive surface
    #: buoyancy flux):
    mass_flux: bool = True
    mf_area: float = 0.1      #: updraft area fraction a_u
    mf_entrain_c: float = 0.4  #: eps = c * (1/z + 1/(h-z))
    mf_excess: float = 0.3    #: surface excess = b * w'x'_s / w*
    mf_w_a: float = 1.0       #: buoyancy production coeff in the w_u eq
    mf_w_b: float = 1.5       #: entrainment drag coeff in the w_u eq


def _div(a, b):
    """``a / b`` as a true division also where ``a`` is a Python number."""
    return over(a, b) if isinstance(a, (int, float)) else a / b


def _add_bottom(x, inc):
    """``x`` with ``inc`` added to its lowest level, as a new tensor."""
    return torch.cat([x[..., :-1, :, :], (x[..., -1, :, :] + inc).unsqueeze(-3)], dim=-3)


def _tridiag_solve(lower, diag, upper, rhs):
    """Thomas algorithm along axis -3 (the k axis), over all columns at once.

    lower[k] couples to k-1, upper[k] to k+1; lower[0] and upper[-1] are
    ignored. A forward sweep and a back substitution, each a loop over k.
    """
    K = diag.shape[-3]
    cp_prev = torch.zeros_like(diag[..., 0, :, :])
    dp_prev = cp_prev
    cps, dps = [], []
    for k in range(K):
        lo = lower[..., k, :, :]
        denom = diag[..., k, :, :] - lo * cp_prev
        cp_prev = upper[..., k, :, :] / denom
        dp_prev = (rhs[..., k, :, :] - lo * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(cp_prev)
    xs = [None] * K
    for k in range(K - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.stack(xs, dim=-3)


def _diffusivities(ua, va, thv, z_mid, z_if, cfg: PBLConfig):
    """Eddy diffusivity K_m at interior interfaces (K-1 of them) + ustar, h."""
    # surface layer = lowest model level (index -1 in k)
    u1 = ua[..., -1, :, :]
    v1 = va[..., -1, :, :]
    spd1 = torch.sqrt(u1 * u1 + v1 * v1) + 1e-6
    z1 = z_mid[..., -1, :, :]
    cd = over(cfg.karman, torch.log(torch.clamp(z1 / cfg.z0, min=1.1))) ** 2
    ustar = torch.sqrt(cd) * spd1

    # --- bulk Richardson number of each level w.r.t. the surface level
    thv1 = thv[..., -1, :, :].unsqueeze(-3)
    du = ua - u1.unsqueeze(-3)
    dv = va - v1.unsqueeze(-3)
    spd2 = du * du + dv * dv + 1e-4
    rib = constants.GRAV * (z_mid - z1.unsqueeze(-3)) * (thv - thv1) / (thv1 * spd2)
    # "within the PBL": every level between it and the surface subcritical
    sub = (rib <= cfg.ricr).to(z_mid.dtype)
    within = torch.flip(torch.cumprod(torch.flip(sub, dims=(-3,)), dim=-3), dims=(-3,))
    h = torch.amax(z_mid * within, dim=-3) + 1e-3  # (S, Y, X)

    # --- K-profile inside the PBL, at interior interfaces k=1..K-1
    z_int = z_if[..., 1:-1, :, :]
    hb = h.unsqueeze(-3)
    zfrac = torch.clamp(z_int / hb, 0.0, 1.0)
    k_pbl = cfg.karman * ustar.unsqueeze(-3) * z_int * (1.0 - zfrac) ** 2 * (z_int < hb)

    # --- local Louis scheme above the PBL
    dz = z_mid[..., :-1, :, :] - z_mid[..., 1:, :, :]  # >0 (k increases down)
    dz = torch.clamp(dz, min=1.0)
    shear = torch.sqrt((ua[..., :-1, :, :] - ua[..., 1:, :, :]) ** 2
                       + (va[..., :-1, :, :] - va[..., 1:, :, :]) ** 2) / dz
    dthv = (thv[..., :-1, :, :] - thv[..., 1:, :, :]) / dz
    thv_if = 0.5 * (thv[..., :-1, :, :] + thv[..., 1:, :, :])
    ri = constants.GRAV * dthv / (thv_if * torch.clamp(shear, min=1e-6) ** 2)
    l_mix = cfg.karman * z_int / (1.0 + cfg.karman * z_int / cfg.l0)
    f_stable = torch.clamp(1.0 - ri / cfg.ricr, min=0.0) ** 2
    f_unstable = torch.sqrt(torch.clamp(1.0 - 18.0 * ri, min=1.0))
    k_free = l_mix ** 2 * shear * torch.where(ri >= 0.0, f_stable, f_unstable)

    k_m = torch.clamp(torch.maximum(k_pbl, k_free), cfg.k_background, cfg.k_max)
    return k_m, ustar, cd, spd1, h


def _mass_flux_tendencies(s, qv, thv, tv, z_mid, dz, p_mid, delp, h, wstar, wthv_sfc,
                          shf, lhf, dt: float, cfg: PBLConfig):
    """EDMF updraft transport of dry static energy and vapor.

    Single entraining updraft: surface excess scaled by w*, entrainment
    eps = c*(1/z + 1/(h-z)), 0.5 d(w^2)/dz = a*B - b*eps*w^2, mass flux
    M = a_u * rho * w_u through the conservative flux form. The plume is a
    loop over k from the lowest level up. Returns (ds_dt, dqv_dt).
    """
    K = s.shape[-3]
    g = constants.GRAV
    convective = wthv_sfc > 1e-8
    wscale = torch.clamp(wstar, min=1e-3)
    # surface excess in the lowest layer
    s1 = s[..., -1, :, :] + _div(cfg.mf_excess * constants.CP_AIR * shf, wscale)
    q1 = qv[..., -1, :, :] + _div(cfg.mf_excess * lhf, wscale)
    hb = torch.clamp(h, min=10.0)
    is_bottom = torch.arange(K, device=s.device) == K - 1
    w2_bottom = (cfg.mf_excess * wscale) ** 2

    s_u = torch.zeros_like(s[..., 0, :, :])
    q_u = s_u
    w2 = s_u
    active = torch.zeros_like(s_u, dtype=torch.bool)
    s_lev, q_lev, m_lev = [], [], []
    for k in range(K - 1, -1, -1):
        s_k, q_k, thv_k = s[..., k, :, :], qv[..., k, :, :], thv[..., k, :, :]
        z_k, dz_k, p_k = z_mid[..., k, :, :], dz[..., k, :, :], p_mid[..., k, :, :]
        bottom_k = is_bottom[k]
        eps = cfg.mf_entrain_c * (over(1.0, torch.clamp(z_k, min=10.0))
                                  + over(1.0, torch.clamp(hb - z_k, min=10.0)))
        edz = eps * dz_k
        f = over(1.0, 1.0 + edz)
        s_u = torch.where(bottom_k, s1, (s_u + edz * s_k) * f)
        q_u = torch.where(bottom_k, q1, (q_u + edz * q_k) * f)
        t_u = (s_u - g * z_k) / constants.CP_AIR
        thv_u = t_u * over(constants.P_REF, p_k) ** constants.KAPPA * (1.0 + constants.ZVIR * q_u)
        buoy = g * (thv_u - thv_k) / thv_k
        w2 = torch.where(bottom_k, w2_bottom,
                         w2 * (1.0 - cfg.mf_w_b * edz) + 2.0 * cfg.mf_w_a * buoy * dz_k)
        active = (bottom_k | active) & (w2 > 0.0) & (z_k < hb)
        w2 = torch.clamp(w2, min=0.0)
        rho_k = p_k / (constants.RDGAS * tv[..., k, :, :])
        m_k = torch.where(active & convective, cfg.mf_area * rho_k * torch.sqrt(w2), 0.0)
        s_lev.append(s_u)
        q_lev.append(q_u)
        m_lev.append(m_k)
    s_u, q_u, m_lay = (torch.stack(a[::-1], dim=-3) for a in (s_lev, q_lev, m_lev))

    # interface mass flux: interface i <- layer i below it; zero at the
    # ground (i=K) and the model top (i=0); a per-interface CFL clip keeps
    # the explicit update stable at any dt
    zero = torch.zeros_like(m_lay[..., :1, :, :])
    m_if = torch.cat([zero, m_lay[..., 1:, :, :], zero], dim=-3)
    dp_min = torch.minimum(torch.cat([delp[..., :1, :, :], delp], dim=-3),
                           torch.cat([delp, delp[..., -1:, :, :]], dim=-3))
    m_if = torch.minimum(m_if, 0.5 * dp_min / (g * dt))
    ds = flux_form_divergence(m_if, s_u, s, delp)
    dq = flux_form_divergence(m_if, q_u, qv, delp)
    return ds, dq


def pbl_step(ua, va, t, qv, pe, p_mid, delp, z_sfc, dt: float, cfg: PBLConfig,
             sensible_heat_flux=None, latent_heat_flux=None):
    """One PBL step. Fields (S, K, Y, X) on the A grid; pe (S, K+1, Y, X).

    Returns (u_dt, v_dt, t_new, qv_new, pbl_height): tendencies of the winds
    (applied by the caller through the A->D projection) and the updated
    thermodynamic fields. ``sensible_heat_flux``/``latent_heat_flux``
    (kinematic, (.., Y, X)) override the config's constants.
    """
    shf = cfg.sensible_heat_flux if sensible_heat_flux is None else sensible_heat_flux
    lhf = cfg.latent_heat_flux if latent_heat_flux is None else latent_heat_flux

    tv = t * (1.0 + constants.ZVIR * qv)
    z_mid, z_if, dz = hydrostatic_heights(tv, pe)

    thv = tv * over(constants.P_REF, p_mid) ** constants.KAPPA
    k_m, ustar, cd, spd1, h = _diffusivities(ua, va, thv, z_mid, z_if, cfg)
    k_h = k_m / cfg.prandtl

    # --- EDMF mass-flux transport of s and qv (convective conditions only)
    s = constants.CP_AIR * t + constants.GRAV * z_mid
    if cfg.mass_flux:
        thv1 = thv[..., -1, :, :]
        wthv_sfc = (shf * (1.0 + constants.ZVIR * qv[..., -1, :, :])
                    + constants.ZVIR * t[..., -1, :, :] * lhf)
        wstar = cbrt(torch.clamp(
            over(constants.GRAV, thv1) * wthv_sfc * torch.clamp(h, min=1.0), min=0.0))
        ds_mf, dq_mf = _mass_flux_tendencies(s, qv, thv, tv, z_mid, dz, p_mid, delp, h, wstar,
                                             wthv_sfc, shf, lhf, dt, cfg)
        s = s + dt * ds_mf
        qv = qv + dt * dq_mf

    # implicit diffusion in pressure coordinates
    rho_if = p_mid / (constants.RDGAS * tv)  # layer rho; averaged to ifaces
    rho2 = (0.5 * (rho_if[..., :-1, :, :] + rho_if[..., 1:, :, :])) ** 2
    dp_if = p_mid[..., 1:, :, :] - p_mid[..., :-1, :, :]  # >0
    g2 = constants.GRAV ** 2

    def build(k_edge, sfc_drag):
        a = dt * g2 * rho2 * k_edge / dp_if  # (S, K-1, Y, X), edge factor
        a_dn = a / delp[..., :-1, :, :]  # coupling of layer k to k+1
        a_up = a / delp[..., 1:, :, :]  # coupling of layer k+1 to k
        zero = torch.zeros_like(delp[..., :1, :, :])
        lower = torch.cat([zero, -a_up], dim=-3)
        upper = torch.cat([-a_dn, zero], dim=-3)
        diag = 1.0 - lower - upper
        if sfc_drag is not None:
            diag = _add_bottom(diag, sfc_drag)
        return lower, diag, upper

    # momentum: implicit surface drag dt*g*rho1*Cd*|U1|/dp_K
    rho1 = rho_if[..., -1, :, :]
    sfc_m = dt * constants.GRAV * rho1 * cd * spd1 / delp[..., -1, :, :]
    lo, di, up = build(k_m, sfc_m)
    ua_new = _tridiag_solve(lo, di, up, ua)
    va_new = _tridiag_solve(lo, di, up, va)

    # dry static energy and moisture (zero-flux surface unless prescribed)
    lo, di, up = build(k_h, None)
    rhs_s = _add_bottom(s, dt * constants.GRAV * rho1 * constants.CP_AIR * shf
                        / delp[..., -1, :, :])
    rhs_q = _add_bottom(qv, dt * constants.GRAV * rho1 * lhf / delp[..., -1, :, :])
    s_new = _tridiag_solve(lo, di, up, rhs_s)
    qv_new = torch.clamp(_tridiag_solve(lo, di, up, rhs_q), min=0.0)
    t_new = (s_new - constants.GRAV * z_mid) / constants.CP_AIR

    u_dt = (ua_new - ua) / dt
    v_dt = (va_new - va) / dt
    return u_dt, v_dt, t_new, qv_new, h
