"""Multi-band (RRTMG-class) correlated-k radiation.

Port of ``pace_tpu.models.shield.band_radiation``: five longwave bands with
their own gas optics (H2O rotation / CO2 15 um / window and continuum / H2O
6.3 um / far tail), temperature-dependent Planck band fractions (cubic fits
of the band-integrated Planck function, computed at import with numpy),
gray cloud longwave optics from the condensate, and a 3-band shortwave
(visible with Rayleigh reflection, two near-IR H2O bands) with cloud
reflection. The same exact exponential layer propagators as
``radiation.py``, with the 1.66 diffusivity factor; ``pace_tpu``'s two
scans (down, then up, the band axis leading) are loops over k on (band, S,
Y, X) planes, summed over the bands at each level and stacked once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import constants
from .microphysics import over
from .radiation import SIGMA_SB, surface_plane, pow4

# ---------------------------------------------------------------------------
# LW band structure [cm^-1] and Planck band fractions
# ---------------------------------------------------------------------------
#: band edges in wavenumber: H2O rotation | CO2 15um | window | H2O 6.3um | tail
LW_EDGES = (0.0, 560.0, 800.0, 1200.0, 2200.0, 1.0e4)
N_LW = len(LW_EDGES) - 1

_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23

#: the trapezoid rule (``np.trapz`` before numpy 2.0, the same sum)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _planck_band_fraction_exact(nu1, nu2, T):
    """Fraction of sigma T^4 emitted in [nu1, nu2] cm^-1 (numpy, numeric)."""
    nu = np.linspace(max(nu1, 1.0), nu2, 400) * 100.0  # -> m^-1
    x = _H * _C * nu / (_KB * T)
    # Planck in wavenumber: B ~ nu^3 / (exp(x)-1); normalize by pi^4/15
    integrand = x**3 / np.expm1(x)
    integral = _trapezoid(integrand, x)
    return integral / (np.pi**4 / 15.0)


def _fit_band_fractions():
    """Cubic fits f_b(T) over 150-340 K (max abs error < 0.004)."""
    ts = np.linspace(150.0, 340.0, 40)
    coefs = []
    for b in range(N_LW):
        fr = np.array([
            _planck_band_fraction_exact(LW_EDGES[b], LW_EDGES[b + 1], t)
            for t in ts
        ])
        coefs.append(np.polyfit((ts - 250.0) / 100.0, fr, 3))
    return np.stack(coefs)  # (N_LW, 4)


_BAND_COEF = _fit_band_fractions()


def planck_band_fractions(t):
    """f_b(T) for every LW band; shape (N_LW,) + t.shape. Sums to ~1."""
    s = ((t - 250.0) / 100.0).reshape(-1)
    c = torch.tensor(_BAND_COEF, dtype=t.dtype).to(t.device)
    f = ((c[:, 0, None] * s + c[:, 1, None]) * s + c[:, 2, None]) * s + c[:, 3, None]
    f = torch.clamp(f, 0.0, 1.0)
    f = f / torch.sum(f, dim=0)  # exact closure
    return f.reshape((N_LW,) + tuple(t.shape))


@dataclasses.dataclass(frozen=True)
class BandRadiationConfig:
    """Gas and cloud optical parameters, ``pace_tpu``'s fields and defaults.
    Absorption coefficients are effective band-mean (correlated-k single-g)
    values [m^2/kg of absorber]."""

    co2_ppmv: float = 400.0
    #: H2O band absorption [m^2/kg vapor]: rotation, 15um wing, window
    #: (continuum, scaled by vapor loading), 6.3um, tail
    k_h2o: tuple = (4.0, 1.0, 0.01, 1.5, 0.2)
    #: CO2 band absorption [m^2/kg CO2]: only the 15um band is strong
    k_co2: tuple = (0.0, 0.5, 0.01, 0.0, 0.02)
    #: pressure-broadening exponent: k ~ (p/p0)^alpha
    alpha_p: float = 0.8
    #: gray cloud LW absorption [m^2/kg condensate]
    k_cloud_lw: float = 100.0
    diffusivity: float = 1.66
    # --- shortwave
    solar_constant: float = 1360.0
    #: SW band split: visible+UV, near-IR weak, near-IR strong
    sw_frac: tuple = (0.52, 0.30, 0.18)
    k_sw_h2o: tuple = (0.0, 0.012, 0.35)  #: [m^2/kg vapor] per SW band
    rayleigh_albedo: float = 0.06  #: visible-band molecular reflection
    # no surface albedo: sw_down_sfc is the downward flux before the
    # surface's reflection, which the surface schemes apply
    #: cloud SW optics: layer reflectance R = tau_c/(tau_c + g0)
    k_cloud_sw: float = 150.0  #: [m^2/kg condensate]
    cloud_g0: float = 7.0
    #: annual/diurnal-mean zenith factor when no sun geometry is supplied
    cos_zenith_mean: float = 0.25


def lw_band_fluxes(t_lay, dtau_b, t_surf):
    """Band-summed (up, down) interface fluxes [W/m^2].

    dtau_b: (N_LW, ..., K, Y, X) per-band layer optical depths (diffusivity
    included). Emission per band uses the local Planck fraction, so exchange
    between warm and cold layers is spectrally resolved."""
    f_lay = planck_band_fractions(t_lay)  # (N_LW, ..., K, Y, X)
    b_tot = SIGMA_SB * pow4(t_lay)
    t_s = surface_plane(t_surf, t_lay[..., 0, :, :])
    f_sfc = planck_band_fractions(t_s)
    b_sfc = SIGMA_SB * pow4(t_s)

    trans = torch.exp(-dtau_b)
    emit = f_lay * b_tot * (1.0 - trans)
    K = trans.shape[-3]
    d = torch.zeros_like(trans[..., 0, :, :])  # (N_LW, ..., Y, X)
    downs = [d.sum(dim=0)]
    for k in range(K):
        d = d * trans[..., k, :, :] + emit[..., k, :, :]
        downs.append(d.sum(dim=0))
    u = f_sfc * b_sfc
    ups = [u.sum(dim=0)]
    for k in range(K - 1, -1, -1):
        u = u * trans[..., k, :, :] + emit[..., k, :, :]
        ups.append(u.sum(dim=0))
    return torch.stack(ups[::-1], dim=-3), torch.stack(downs, dim=-3)


def lw_band_optical_depths(qv, qc, p_mid, delp, cfg: BandRadiationConfig):
    """(N_LW, ..., K, Y, X) per-band layer optical depths."""
    dm = delp / constants.GRAV  # air path [kg/m^2]
    u_v = qv * dm               # vapor path
    u_c2 = cfg.co2_ppmv * 1e-6 * (44.01 / 28.964) * dm
    scale = (p_mid / constants.P_REF) ** cfg.alpha_p
    parts = []
    for b in range(N_LW):
        tau = cfg.k_h2o[b] * u_v * scale + cfg.k_co2[b] * u_c2 * scale
        if b == 2:
            # window continuum: self-broadened, ~ vapor path * vapor loading
            tau = tau * (1.0 + 30.0 * qv)
        parts.append(tau)
    tau_b = torch.stack(parts, dim=0)
    if qc is not None:
        tau_b = tau_b + cfg.k_cloud_lw * (qc * dm).unsqueeze(0)
    return cfg.diffusivity * tau_b


def sw_fluxes(qv, qc, delp, cosz, cfg: BandRadiationConfig):
    """Downward SW at interfaces, band-summed [W/m^2], and the TOA input.

    Direct-beam Beer-Lambert per near-IR band along the slant path; the
    visible band is attenuated only by Rayleigh and cloud reflection (at the
    top, from the column's total cloud path). Returns (sw_down_if, toa_in).
    """
    dm = delp / constants.GRAV
    s0 = cfg.solar_constant * cosz
    # column cloud reflectance
    if qc is not None:
        tau_c = cfg.k_cloud_sw * torch.sum(qc * dm, dim=-3)
    else:
        tau_c = torch.zeros_like(torch.sum(dm, dim=-3))
    r_cloud = tau_c / (tau_c + cfg.cloud_g0)
    slant = over(1.0, torch.clamp(cosz, min=0.05))

    downs = []
    for b in range(3):
        top = s0 * cfg.sw_frac[b]
        if b == 0:
            top = top * (1.0 - cfg.rayleigh_albedo)
        top = top * (1.0 - r_cloud)
        dtau = cfg.k_sw_h2o[b] * qv * dm * slant.unsqueeze(-3)
        # cumulative transmission to every interface
        ctau = torch.cumsum(dtau, dim=-3)
        ctau_if = torch.cat([torch.zeros_like(ctau[..., :1, :, :]), ctau], dim=-3)
        downs.append(top.unsqueeze(-3) * torch.exp(-ctau_if))
    return sum(downs), s0


def band_radiation_step_fluxes(pt, pkz, pe, ps, dt: float, cfg: BandRadiationConfig, qv=None,
                               qc=None, t_surf=None, cosz=None):
    """One multi-band radiation step on dycore fields.

    Returns (pt_new, lw_down_sfc, sw_down_sfc), the coupling surface of
    ``gray_radiation_step_fluxes`` plus the attenuated SW. ``qc``: total
    condensate (liquid + ice) mixing ratio for the cloud optics."""
    t_lay = pt * pkz
    delp = pe[..., 1:, :, :] - pe[..., :-1, :, :]
    p_mid = 0.5 * (pe[..., 1:, :, :] + pe[..., :-1, :, :])
    if qv is None:
        qv = torch.zeros_like(t_lay)
    if t_surf is None:
        t_surf = t_lay[..., -1, :, :]
    if cosz is None:
        cosz = torch.full_like(ps, cfg.cos_zenith_mean)

    dtau_b = lw_band_optical_depths(qv, qc, p_mid, delp, cfg)
    up, down = lw_band_fluxes(t_lay, dtau_b, t_surf)
    sw_dn, _ = sw_fluxes(qv, qc, delp, cosz, cfg)

    # heating from the LW net-up divergence and the SW absorption:
    # dT/dt = g/cp * (d(up - down) + absorbed SW)/dp
    dnet_lw = (up - down)[..., 1:, :, :] - (up - down)[..., :-1, :, :]
    dsw = sw_dn[..., :-1, :, :] - sw_dn[..., 1:, :, :]  # absorbed per layer
    heating = constants.GRAV / constants.CP_AIR * (dnet_lw + dsw) / delp
    t_new = t_lay + dt * heating
    return pt * (t_new / t_lay), down[..., -1, :, :], sw_dn[..., -1, :, :]


def olr(pt, pkz, pe, ps, cfg: BandRadiationConfig, qv=None, qc=None, t_surf=None):
    """Outgoing longwave at TOA [W/m^2] (diagnostic)."""
    t_lay = pt * pkz
    delp = pe[..., 1:, :, :] - pe[..., :-1, :, :]
    p_mid = 0.5 * (pe[..., 1:, :, :] + pe[..., :-1, :, :])
    if qv is None:
        qv = torch.zeros_like(t_lay)
    if t_surf is None:
        t_surf = t_lay[..., -1, :, :]
    dtau_b = lw_band_optical_depths(qv, qc, p_mid, delp, cfg)
    up, _ = lw_band_fluxes(t_lay, dtau_b, t_surf)
    return up[..., 0, :, :]
