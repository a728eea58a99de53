"""Jablonowski & Williamson (2006, QJRMS) baroclinic-wave initial condition.

The port's own copy of ``pace_tpu.models.fv3.init_baroclinic`` (reference
role: ``pyFV3.initialization.analytic_init`` case "baroclinic"). The
unperturbed state is an exact steady solution of the hydrostatic primitive
equations — the standard dycore steadiness/validation anchor. All evaluation
is host-side numpy at f64 (init is not performance-critical).
"""

from __future__ import annotations

import numpy as np

from ... import constants
from ...grid.generation import MetricTerms

U0 = 35.0  # max zonal jet speed [m/s]
ETA_0 = 0.252
ETA_T = 0.2  # tropopause eta
T_0 = 288.0
GAMMA = 0.005  # lapse rate [K/m]
DELTA_T = 4.8e5  # stratosphere temperature-profile coefficient
U_P = 1.0  # perturbation amplitude [m/s]
LON_C = np.pi / 9.0  # perturbation center
LAT_C = 2.0 * np.pi / 9.0
PS0 = 1.0e5


def _eta_v(eta):
    return (eta - ETA_0) * np.pi / 2.0


def zonal_wind(lat, eta):
    """Balanced zonal wind [m/s]."""
    ev = _eta_v(eta)
    return U0 * np.cos(ev) ** 1.5 * np.sin(2.0 * lat) ** 2


def mean_temperature(eta):
    rd = constants.RDGAS
    g = constants.GRAV
    t = T_0 * eta ** (rd * GAMMA / g)
    t = np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)
    return t


def temperature(lat, eta):
    """Full balanced temperature [K] (JW06 eq. 6)."""
    a = constants.RADIUS
    omega = constants.OMEGA
    rd = constants.RDGAS
    ev = _eta_v(eta)
    tmean = mean_temperature(eta)
    fac1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
    fac2 = (8.0 / 5.0) * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0) - np.pi / 4.0
    dtdy = (
        0.75
        * (eta * np.pi * U0 / rd)
        * np.sin(ev)
        * np.sqrt(np.cos(ev))
        * (fac1 * 2.0 * U0 * np.cos(ev) ** 1.5 + fac2 * a * omega)
    )
    return tmean + dtdy


def surface_geopotential(lat):
    """Balanced surface geopotential [m^2/s^2] (JW06 eq. 7)."""
    a = constants.RADIUS
    omega = constants.OMEGA
    evs = _eta_v(1.0)
    fac1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
    fac2 = (8.0 / 5.0) * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0) - np.pi / 4.0
    u_s = U0 * np.cos(evs) ** 1.5
    return u_s * (fac1 * u_s + fac2 * a * omega)


def wind_perturbation(lon, lat):
    """Zonal wind perturbation triggering the wave (JW06 eq. 8)."""
    a_ref = 0.1  # R = a/10
    r = np.arccos(
        np.clip(
            np.sin(LAT_C) * np.sin(lat)
            + np.cos(LAT_C) * np.cos(lat) * np.cos(lon - LON_C),
            -1.0,
            1.0,
        )
    )
    return U_P * np.exp(-((r / a_ref) ** 2))


def init_baroclinic_state(mt: MetricTerms, perturbation: bool = True):
    """Build the full initial state on the stacked-shard layout.

    Returns a dict of numpy arrays: u (S, K, Y+1, X), v (S, K, Y, X+1),
    delp/pt (S, K, Y, X), phis (S, Y, X), ps (S, Y, X). ``pt`` is virtual
    potential temperature (dry: theta = T / pkz-equivalent at layer mean).
    """
    ak, bk = mt.ak, mt.bk
    npz = len(ak) - 1
    S = mt.lon_agrid.shape[0]

    def lon_lat(xyz):
        lon = np.arctan2(xyz[..., 1], xyz[..., 0])
        lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
        return lon, lat

    # interface pressures for uniform ps
    pe1 = ak + bk * PS0  # (npz+1,)
    eta_mid = 0.5 * (pe1[:-1] + pe1[1:]) / PS0  # (npz,)

    # --- winds on the D grid: covariant projections of the physical wind
    # (meridional wind is zero in JW06, so only the east unit vector matters)
    lon_u, lat_u = lon_lat(mt.xyz_u)
    lon_v, lat_v = lon_lat(mt.xyz_v)
    east_u = np.stack(
        [-np.sin(lon_u), np.cos(lon_u), np.zeros_like(lon_u)], axis=-1
    )
    east_v = np.stack(
        [-np.sin(lon_v), np.cos(lon_v), np.zeros_like(lon_v)], axis=-1
    )
    u = np.empty((S, npz) + lat_u.shape[1:])
    v = np.empty((S, npz) + lat_v.shape[1:])
    for k in range(npz):
        spd_u = zonal_wind(lat_u, eta_mid[k])
        spd_v = zonal_wind(lat_v, eta_mid[k])
        if perturbation:
            spd_u = spd_u + wind_perturbation(lon_u, lat_u)
            spd_v = spd_v + wind_perturbation(lon_v, lat_v)
        u[:, k] = np.sum(spd_u[..., None] * east_u * mt.es1, axis=-1)
        v[:, k] = np.sum(spd_v[..., None] * east_v * mt.ew2, axis=-1)

    # --- thermodynamics at cell centers
    lat_a = mt.lat_agrid
    phis = surface_geopotential(lat_a)
    ps = np.full_like(phis, PS0)
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]  # (S, K+1, Y, X)
    delp = pe[:, 1:] - pe[:, :-1]
    peln = np.log(pe)
    pk = (pe / constants.P_REF) ** constants.KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (
        constants.KAPPA * (peln[:, 1:] - peln[:, :-1])
    )
    pt = np.empty_like(delp)
    for k in range(npz):
        t_k = temperature(lat_a, eta_mid[k])
        pt[:, k] = t_k / pkz[:, k]  # potential temperature (dry => theta_v)

    return dict(u=u, v=v, delp=delp, pt=pt, phis=phis, ps=ps)
