"""Gray-atmosphere radiation (Frierson et al. 2006).

Port of ``pace_tpu.models.shield.radiation``: one broadband longwave
optical depth, prescribed by latitude (or built from the simulated humidity,
Byrne & O'Gorman 2013), exact exponential propagation of the two streams
through each layer, and shortwave that the gray atmosphere does not absorb:
it reaches the surface, whose scheme applies its own albedo. The two
``lax.scan``s of ``pace_tpu`` (down, then up) are loops over k on whole
(S, Y, X) planes, collected in lists and stacked once.

The diurnal and seasonal insolation reads the model time. ``pace_tpu``'s
jitted ``Physics`` holds that time as float32, and XLA computes the
float32 solar geometry from it with its own algebra: a division by a
constant as a multiply by the constant's float32 reciprocal, a fused
multiply-add, products of constants folded, and libm's ``cosf`` and
``sinf``. :func:`solar_geometry` computes the same float32 numbers on the
host, so that a float64 run agrees with ``pace_tpu``'s to rounding.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np
import torch

from ... import constants

SIGMA_SB = 5.670374419e-8  #: Stefan-Boltzmann [W m^-2 K^-4]


@dataclasses.dataclass(frozen=True)
class GrayRadiationConfig:
    """Frierson et al. (2006) table 1 values: ``pace_tpu``'s fields and
    defaults."""

    tau0_eq: float = 6.0     #: surface LW optical depth, equator
    tau0_pole: float = 1.5   #: surface LW optical depth, pole
    f_l: float = 0.1         #: linear (well-mixed) fraction of tau(p)
    solar_constant: float = 1360.0
    albedo: float = 0.31
    del_sol: float = 1.4     #: P2(lat) shortwave contrast parameter
    t_surf: float = 288.0    #: prescribed surface temperature [K] (no slab)
    #: --- diurnal cycle (off = Frierson annual/diurnal-mean P2 forcing):
    diurnal: bool = False
    day_length: float = 86400.0     #: solar day [s]
    declination_deg: float = 0.0    #: solar declination (0 = equinox)
    #: seasonal cycle: declination follows the day of year (t=0 is Jan 1,
    #: northern winter); overrides declination_deg
    seasonal: bool = False
    year_length: float = 365.25 * 86400.0
    obliquity_deg: float = 23.44
    #: --- interactive water vapor: tau from the simulated humidity
    interactive_vapor: bool = False
    kappa_v: float = 0.17    #: vapor LW absorption [m^2/kg]
    kappa_d: float = 1.5e-4  #: dry-air LW absorption [m^2/kg] (tau_dry ~1.5)


def pow4(x):
    """``x**4`` as ``pace_tpu``'s integer power computes it: (x x)(x x)."""
    x2 = x * x
    return x2 * x2


def sin_latitude(f0):
    """sin(lat) from the Coriolis parameter at cell centers, clipped to
    [-1, 1]. The division by 2 Omega is a multiply by its reciprocal, as
    XLA compiles ``pace_tpu``'s ``f0 / (2 Omega)``: the latitude masks then
    fall on the same points on every device."""
    return torch.clamp(f0 * (1.0 / (2.0 * constants.OMEGA)), -1.0, 1.0)


def optical_depth(p_if, ps, sinlat2, cfg: GrayRadiationConfig):
    """tau at layer interfaces: tau0(lat) * (f_l*s + (1-f_l)*s^4), s=p/ps."""
    tau0 = cfg.tau0_eq + (cfg.tau0_pole - cfg.tau0_eq) * sinlat2
    s = p_if / ps.unsqueeze(-3)
    return tau0.unsqueeze(-3) * (cfg.f_l * s + (1.0 - cfg.f_l) * pow4(s))


def optical_depth_interactive(qv, delp, cfg: GrayRadiationConfig):
    """tau at interfaces from the simulated humidity: d tau = (kappa_v*qv +
    kappa_d) dp/g, summed down the column."""
    dtau = (cfg.kappa_v * qv + cfg.kappa_d) * delp / constants.GRAV
    zero = torch.zeros_like(dtau[..., :1, :, :])
    return torch.cat([zero, torch.cumsum(dtau, dim=-3)], dim=-3)


def surface_plane(t_surf, like):
    """``t_surf`` (a number or a tensor broadcastable to ``like``) as a
    tensor of ``like``'s shape, dtype and device."""
    if isinstance(t_surf, torch.Tensor):
        return t_surf.expand(like.shape)
    return torch.full_like(like, t_surf)


def lw_fluxes(t_lay, tau_if, t_surf):
    """Two-stream gray LW: exact per-layer exponential propagation.

    Down:  D_{k+1} = D_k e^{-dtau} + B_k (1 - e^{-dtau})
    Up:    U_k     = U_{k+1} e^{-dtau} + B_k (1 - e^{-dtau})
    with B = sigma T^4 per layer, D_top = 0, U_surf = sigma T_s^4.
    Returns (up, down) at interfaces, shape of ``tau_if``.
    """
    b_lay = SIGMA_SB * pow4(t_lay)
    dtau = tau_if[..., 1:, :, :] - tau_if[..., :-1, :, :]
    trans = torch.exp(-dtau)
    emit = b_lay * (1.0 - trans)
    K = trans.shape[-3]
    d = torch.zeros_like(trans[..., 0, :, :])
    downs = [d]
    for k in range(K):
        d = d * trans[..., k, :, :] + emit[..., k, :, :]
        downs.append(d)
    u = SIGMA_SB * pow4(surface_plane(t_surf, d))
    ups = [u]
    for k in range(K - 1, -1, -1):
        u = u * trans[..., k, :, :] + emit[..., k, :, :]
        ups.append(u)
    return torch.stack(ups[::-1], dim=-3), torch.stack(downs, dim=-3)


def sw_surface(sinlat2, cfg: GrayRadiationConfig):
    """Shortwave absorbed at the surface: S0/4 (1 + del_sol P2) (1-albedo)
    with P2 = (1 - 3 sin^2)/4 (annual-mean Frierson forcing)."""
    p2 = (1.0 - 3.0 * sinlat2) / 4.0
    return cfg.solar_constant / 4.0 * (1.0 + cfg.del_sol * p2) * (1.0 - cfg.albedo)


@functools.lru_cache(maxsize=None)
def _libm_f32(name):
    """libm's single-precision ``name`` (``cosf`` or ``sinf``)."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6"), name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]
    return fn


def _f32_call(name, x):
    return np.float32(_libm_f32(name)(float(x)))


def _fma32(a, b, c):
    """float32 a*b + c with one rounding (the float64 product of two float32
    numbers is exact)."""
    return np.float32(float(a) * float(b) + float(c))


def solar_geometry(time_seconds, cfg: GrayRadiationConfig):
    """``(sin_d, cos_d, hour0)``: the sine and cosine of the solar
    declination and the hour angle's time term ``2 pi t / day_length`` [rad]
    at ``time_seconds``, held as float32 as ``pace_tpu``'s ``Physics`` holds
    it. Seasonal declination ``-obliquity cos(2 pi (t / year + 10 / 365.25))``
    (Jan-1 epoch, solstice lag of about 10 days) in float32; otherwise the
    fixed ``declination_deg`` in float64. Host numbers (Python floats)."""
    f32 = np.float32
    t = f32(time_seconds)
    if cfg.seasonal:
        u = _fma32(t, f32(1.0) / f32(cfg.year_length), f32(10.0 / 365.25))
        phase = f32(f32(2.0 * math.pi) * u)
        decl = f32(f32(-float(np.radians(cfg.obliquity_deg))) * _f32_call("cosf", phase))
        sin_d, cos_d = float(_f32_call("sinf", decl)), float(_f32_call("cosf", decl))
    else:
        decl = float(np.radians(cfg.declination_deg))
        sin_d, cos_d = float(np.sin(decl)), float(np.cos(decl))
    hour0 = float(t * f32(f32(1.0) / f32(cfg.day_length) * f32(2.0 * math.pi)))
    return sin_d, cos_d, hour0


def sw_down_surface(sinlat2, cfg: GrayRadiationConfig, lat=None, lon=None, time_seconds=None):
    """Downward SW at the surface before the surface's albedo, the forcing an
    interactive surface scheme takes. The gray atmosphere is SW-transparent.

    Default: the Frierson annual/diurnal-mean P2 profile. With
    ``cfg.diurnal`` and (lat, lon [rad], time_seconds) supplied:
    instantaneous insolation S0 * max(cos(zenith), 0) from the solar hour
    angle (:func:`solar_geometry`)."""
    if cfg.diurnal and lat is not None and lon is not None and time_seconds is not None:
        sin_d, cos_d, hour0 = solar_geometry(time_seconds, cfg)
        # hour angle: solar noon at lon=0 when time mod day = day/2
        hour = hour0 + lon - math.pi
        cosz = torch.sin(lat) * sin_d + torch.cos(lat) * cos_d * torch.cos(hour)
        return cfg.solar_constant * torch.clamp(cosz, min=0.0)
    p2 = (1.0 - 3.0 * sinlat2) / 4.0
    return cfg.solar_constant / 4.0 * (1.0 + cfg.del_sol * p2)


def gray_radiation_step_fluxes(pt, pkz, pe, ps, sinlat2, dt: float, cfg: GrayRadiationConfig,
                               t_surf=None, qv=None):
    """One radiation step on dycore fields: returns (updated pt, LW down at
    the surface [W/m^2]).

    Heating dT/dt = g/cp * d(net_up)/dp from the exact layer propagators,
    applied explicitly. ``t_surf`` (a number or a (.., Y, X) tensor)
    overrides the prescribed surface temperature: the interactive-surface
    coupling. With ``interactive_vapor`` and ``qv``, the optical depth comes
    from the simulated humidity. A new ``pt``; nothing is written in place.
    """
    t_lay = pt * pkz  # dry: T = pt * pkz
    if cfg.interactive_vapor and qv is not None:
        delp = pe[..., 1:, :, :] - pe[..., :-1, :, :]
        tau = optical_depth_interactive(qv, delp, cfg)
    else:
        tau = optical_depth(pe, ps, sinlat2, cfg)
    if t_surf is None:
        t_surf = cfg.t_surf
    up, down = lw_fluxes(t_lay, tau, t_surf)
    net = up - down  # positive upward
    dnet = net[..., 1:, :, :] - net[..., :-1, :, :]
    dp = pe[..., 1:, :, :] - pe[..., :-1, :, :]
    heating = constants.GRAV / constants.CP_AIR * dnet / dp  # [K/s]
    t_new = t_lay + dt * heating
    return pt * (t_new / t_lay), down[..., -1, :, :]


def gray_radiation_step(pt, pkz, pe, ps, sinlat2, dt: float, cfg: GrayRadiationConfig):
    """One radiation step on dycore fields: returns updated pt."""
    pt_new, _ = gray_radiation_step_fluxes(pt, pkz, pe, ps, sinlat2, dt, cfg)
    return pt_new
