"""Reed & Jablonowski (2012) "simple physics" for idealized tropical-cyclone
runs.

Port of ``pace_tpu.models.shield.simple_physics``, three column components
in the RJ2012 order:

1. large-scale condensation: supersaturated levels condense to saturation,
   the latent heat warms the level, the condensate rains out at once;
2. bulk aerodynamic surface fluxes over a fixed-SST ocean, Cd = 7e-4 +
   6.5e-5 |v| (2e-3 above 20 m/s), C_H = C_E = 1.1e-3, implicit on the
   lowest level;
3. implicit PBL diffusion of momentum, potential temperature and moisture
   with K = C |v1| z_a below 850 hPa and a Gaussian decay above.

The implicit diffusion is the Thomas algorithm of ``pbl.py``, a loop over k
on whole (S, Y, X) planes where ``pace_tpu`` scans.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants
from .microphysics import over
from .pbl import _tridiag_solve


@dataclasses.dataclass(frozen=True)
class SimplePhysicsConfig:
    """``pace_tpu``'s fields and defaults."""

    sst: float = 302.15          #: fixed sea-surface temperature [K]
    cd0: float = 7.0e-4          #: neutral drag coefficient intercept
    cd1: float = 6.5e-5          #: drag coefficient wind slope [s/m]
    cd_cap: float = 2.0e-3       #: drag above 20 m/s (RJ2012 eq. 12)
    c_hq: float = 1.1e-3         #: heat/moisture exchange coefficient
    pbl_top: float = 850.0e2     #: full-strength diffusion below [Pa]
    pbl_const: float = 100.0e2   #: Gaussian decay scale above [Pa]
    #: saturation vapor pressure constants (RJ2012 eq. 5)
    e0: float = 610.78
    t0c: float = 273.16


def _qsat(t, p, cfg: SimplePhysicsConfig):
    """Saturation mixing ratio, RJ2012's Clausius-Clapeyron form."""
    es = cfg.e0 * torch.exp((constants.HLV / constants.RVGAS) * (1.0 / cfg.t0c - over(1.0, t)))
    return (constants.RDGAS / constants.RVGAS) * es / torch.maximum(p, es)


def _condense(t, qv, p_mid, delp, dt, cfg):
    """Component 1: large-scale condensation and immediate rain-out."""
    qs = _qsat(t, p_mid, cfg)
    gamma = 1.0 + (constants.HLV**2 * qs / (constants.CP_AIR * constants.RVGAS * t**2))
    dq = torch.clamp(qv - qs, min=0.0) / gamma
    t = t + (constants.HLV / constants.CP_AIR) * dq
    qv = qv - dq
    precip = torch.sum(dq * delp, dim=-3) / constants.GRAV  # [kg/m^2]
    return t, qv, precip


def _tridiag_implicit(x, ka, dp_mid, dp_int, dt):
    """Solve (I - dt * D) x_new = x for implicit vertical diffusion in
    pressure coordinates, D the flux-form diffusion operator with interface
    diffusivities ``ka`` (in Pa^2/s: K * (rho g)^2) at the K-1 interior
    interfaces; k on axis -3."""
    c = dt * ka / (dp_int * dp_mid[..., :-1, :, :])   # upper coupling
    a = dt * ka / (dp_int * dp_mid[..., 1:, :, :])    # lower coupling
    zero = torch.zeros_like(x[..., :1, :, :])
    lower = torch.cat([zero, -a], dim=-3)          # a_k x_{k-1}
    upper = torch.cat([-c, zero], dim=-3)          # c_k x_{k+1}
    diag = 1.0 - lower - upper
    return _tridiag_solve(lower, diag, upper, x)


def simple_physics_step(ua, va, t, qv, pe, p_mid, delp, phis, dt, cfg: SimplePhysicsConfig):
    """One RJ2012 simple-physics step on A-grid columns.

    ua/va/t/qv: (S, K, Y, X), the lowest level at k=K-1; pe: (S, K+1, Y, X).
    Returns (u_dt, v_dt, t_new, qv_new, precip_rate [kg/m^2/s]), the wind
    changes as A-grid tendencies (the caller projects them onto the D grid
    with ``apply_wind_tendencies``)."""
    ua0, va0 = ua, va
    # --- 1. large-scale condensation
    t, qv, precip = _condense(t, qv, p_mid, delp, dt, cfg)

    # --- 2. bulk surface fluxes, implicit on the lowest level
    u1 = ua[..., -1:, :, :]
    v1 = va[..., -1:, :, :]
    t1 = t[..., -1:, :, :]
    q1 = qv[..., -1:, :, :]
    wind = torch.sqrt(u1 * u1 + v1 * v1)
    cd = torch.where(wind < 20.0, cfg.cd0 + cfg.cd1 * wind, cfg.cd_cap)
    # lowest-level height above the surface [m]
    ps = pe[..., -1:, :, :]
    ta_v = t1 * (1.0 + constants.ZVIR * q1)
    za = constants.RDGAS * ta_v / constants.GRAV * torch.log(ps / p_mid[..., -1:, :, :])
    fm = over(1.0, 1.0 + cd * wind * dt / za)
    u1n = u1 * fm
    v1n = v1 * fm
    ch = cfg.c_hq
    fh = ch * wind * dt / za
    qsat_s = _qsat(torch.full_like(t1, cfg.sst), ps, cfg)
    t1n = (t1 + fh * cfg.sst) / (1.0 + fh)
    q1n = (q1 + fh * qsat_s) / (1.0 + fh)
    ua = torch.cat([ua[..., :-1, :, :], u1n], dim=-3)
    va = torch.cat([va[..., :-1, :, :], v1n], dim=-3)
    t = torch.cat([t[..., :-1, :, :], t1n], dim=-3)
    qv = torch.cat([qv[..., :-1, :, :], q1n], dim=-3)

    # --- 3. PBL diffusion (implicit, pressure-coordinate flux form)
    p_int = pe[..., 1:-1, :, :]  # interior interfaces (K-1)
    shape_decay = torch.where(
        p_int > cfg.pbl_top, 1.0,
        torch.exp(-(((cfg.pbl_top - p_int) / cfg.pbl_const) ** 2)))
    km_s = cd * wind * za       # momentum diffusivity at the surface [m^2/s]
    ke_s = ch * wind * za
    # the interface's (rho g)^2 converts K [m^2/s] to Pa^2/s
    t_int = 0.5 * (t[..., 1:, :, :] + t[..., :-1, :, :])
    qv_int = 0.5 * (qv[..., 1:, :, :] + qv[..., :-1, :, :])
    rho = p_int / (constants.RDGAS * t_int * (1.0 + constants.ZVIR * qv_int))
    fac = (rho * constants.GRAV) ** 2
    dp_int = p_mid[..., 1:, :, :] - p_mid[..., :-1, :, :]
    km = km_s * shape_decay * fac
    ke = ke_s * shape_decay * fac

    ua_n = _tridiag_implicit(ua, km, delp, dp_int, dt)
    va_n = _tridiag_implicit(va, km, delp, dp_int, dt)
    # diffuse potential temperature (RJ2012) on the model levels
    exner = (p_mid / 1.0e5) ** (constants.RDGAS / constants.CP_AIR)
    theta = t / exner
    t_n = _tridiag_implicit(theta, ke, delp, dp_int, dt) * exner
    qv_n = _tridiag_implicit(qv, ke, delp, dp_int, dt)

    u_dt = (ua_n - ua0) / dt
    v_dt = (va_n - va0) / dt
    return u_dt, v_dt, t_n, qv_n, precip / dt
