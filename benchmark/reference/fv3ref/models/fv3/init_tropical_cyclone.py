"""Reed & Jablonowski (2011, JAMES) idealized tropical cyclone initial state.

The port's own copy of ``pace_tpu.models.fv3.init_tropical_cyclone``
(reference role: ``pyFV3.initialization.analytic_init`` case
"tropicalcyclone"; ``examples/configs/tropicalcyclone_c128.yaml`` pairs the
case with a Schmidt-stretched C128 grid). The state is an analytic
axisymmetric warm-core vortex in gradient-wind and hydrostatic balance over a
moist background sounding; all evaluation is host-side numpy f64, the Newton
iteration for the layers' heights split over threads by shard.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import constants
from ...grid.generation import MetricTerms

# RJ2011 / DCMIP-2016 TC test constants
T00 = 302.15  # surface background temperature [K]
Q0 = 0.021  # surface specific humidity [kg/kg]
ZQ1 = 3000.0  # humidity decay height [m]
ZQ2 = 8000.0  # humidity quadratic decay height [m]
GAMMA_TC = 0.007  # lapse rate [K/m]
Z_TROP = 15000.0  # tropopause height [m]
P00 = 101500.0  # background surface pressure [Pa]
DELTA_P = 1115.0  # central surface pressure depression [Pa]
R_P = 282000.0  # vortex radial scale [m]
Z_P = 7000.0  # vortex vertical scale [m]
Q_TROP = 1.0e-11  # stratospheric specific humidity [kg/kg]
LAT_C = np.deg2rad(10.0)  # vortex center latitude
LON_C = np.pi  # vortex center longitude
EPS_V = 0.608  # Rv/Rd - 1 used by RJ2011


def _background():
    tv0 = T00 * (1.0 + EPS_V * Q0)
    tvt = tv0 - GAMMA_TC * Z_TROP
    g = constants.GRAV
    rd = constants.RDGAS
    exponent = g / (rd * GAMMA_TC)
    p_trop = P00 * (tvt / tv0) ** exponent
    return tv0, tvt, exponent, p_trop


def specific_humidity(z):
    """RJ2011 eq. for q(z): moist below the tropopause, ~dry above."""
    q = Q0 * np.exp(-z / ZQ1) * np.exp(-((z / ZQ2) ** 2))
    return np.where(z < Z_TROP, q, Q_TROP)


def pressure(r, z):
    """p(r, z) [Pa] (RJ2011 eqs. 5-6)."""
    tv0, tvt, exponent, p_trop = _background()
    g = constants.GRAV
    rd = constants.RDGAS
    below = (
        P00 - DELTA_P * np.exp(-((r / R_P) ** 1.5)) * np.exp(-((z / Z_P) ** 2))
    ) * ((tv0 - GAMMA_TC * z) / tv0) ** exponent
    above = p_trop * np.exp(-g * (z - Z_TROP) / (rd * tvt))
    return np.where(z < Z_TROP, below, above)


def virtual_temperature(r, z):
    """Tv(r, z) [K] (RJ2011 eq. 7)."""
    tv0, tvt, _, _ = _background()
    g = constants.GRAV
    rd = constants.RDGAS
    tvbar = tv0 - GAMMA_TC * z
    denom = 1.0 + (2.0 * rd * tvbar * z) / (
        g
        * Z_P**2
        * (
            1.0
            - (P00 / DELTA_P)
            * np.exp((r / R_P) ** 1.5)
            * np.exp((z / Z_P) ** 2)
        )
    )
    tv = tvbar / denom
    return np.where(z < Z_TROP, tv, tvt)


def tangential_wind(r, z):
    """Gradient-wind-balanced tangential wind [m/s] (RJ2011 eq. 8);
    cyclonic (counterclockwise) positive in the northern hemisphere."""
    tv0, _, _, _ = _background()
    g = constants.GRAV
    rd = constants.RDGAS
    fc = 2.0 * constants.OMEGA * np.sin(LAT_C)
    tvbar = tv0 - GAMMA_TC * z
    bracket = (
        1.0
        + (2.0 * rd * tvbar * z) / (g * Z_P**2)
        - (P00 / DELTA_P) * np.exp((r / R_P) ** 1.5) * np.exp((z / Z_P) ** 2)
    )
    term = (fc * r / 2.0) ** 2 - (1.5 * (r / R_P) ** 1.5 * tvbar * rd) / bracket
    vt = -fc * r / 2.0 + np.sqrt(np.maximum(term, 0.0))
    return np.where(z < Z_TROP, vt, 0.0)


def _height_of_pressure(r, p_target, n_iter: int = 25):
    """Invert p(r, z) = p_target for z by Newton iteration (vectorized).
    dp/dz = -p g / (Rd Tv) by hydrostatic balance."""
    tv0, _, _, _ = _background()
    g = constants.GRAV
    rd = constants.RDGAS
    # first guess: dry background profile
    z = (tv0 / GAMMA_TC) * (
        1.0 - np.minimum(p_target / P00, 1.0) ** (rd * GAMMA_TC / g)
    )
    for _ in range(n_iter):
        p = pressure(r, z)
        tv = virtual_temperature(r, z)
        dpdz = -p * g / (rd * np.maximum(tv, 1.0))
        z = z - (p - p_target) / dpdz
        z = np.maximum(z, 0.0)
    return z


def _heights_of_pressure(r, p_target):
    """``_height_of_pressure`` of each shard (the leading axis) in a thread
    of its own. numpy releases the GIL in its elementwise loops and each
    point's iteration is independent of the others, so the result is the
    one call's, bit for bit, in a fraction of its time."""
    with ThreadPoolExecutor(max_workers=min(len(r), os.cpu_count() or 1)) as pool:
        return np.stack(list(pool.map(_height_of_pressure, r, p_target)))


def _radius_and_azimuth(lon, lat):
    """Great-circle distance from the vortex center and the (east, north)
    components of the cyclonic tangential unit vector (DCMIP convention)."""
    a = constants.RADIUS
    dlon = lon - LON_C
    cos_d = np.clip(
        np.sin(LAT_C) * np.sin(lat)
        + np.cos(LAT_C) * np.cos(lat) * np.cos(dlon),
        -1.0,
        1.0,
    )
    r = a * np.arccos(cos_d)
    d1 = np.sin(LAT_C) * np.cos(lat) - np.cos(LAT_C) * np.sin(lat) * np.cos(
        dlon
    )
    d2 = np.cos(LAT_C) * np.sin(dlon)
    d = np.maximum(np.sqrt(d1**2 + d2**2), 1.0e-25)
    return r, d1 / d, d2 / d


def init_tropical_cyclone_state(mt: MetricTerms):
    """Build the full initial state on the stacked-shard layout.

    Returns a dict of numpy arrays: u (S, K, Y+1, X), v (S, K, Y, X+1),
    delp/pt (S, K, Y, X), phis/ps (S, Y, X), qvapor (S, K, Y, X). ``pt`` is
    virtual potential temperature (consistent with the dycore's prognostic).
    """
    ak, bk = mt.ak, mt.bk
    npz = len(ak) - 1
    S = mt.lon_agrid.shape[0]

    def lon_lat(xyz):
        lon = np.arctan2(xyz[..., 1], xyz[..., 0]) % (2.0 * np.pi)
        lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
        return lon, lat

    # --- surface pressure and interface pressures at cell centers
    lon_a, lat_a = mt.lon_agrid % (2.0 * np.pi), mt.lat_agrid
    r_a, _, _ = _radius_and_azimuth(lon_a, lat_a)
    ps = P00 - DELTA_P * np.exp(-((r_a / R_P) ** 1.5))
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = pe[:, 1:] - pe[:, :-1]
    peln = np.log(pe)
    pk = (pe / constants.P_REF) ** constants.KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (
        constants.KAPPA * (peln[:, 1:] - peln[:, :-1])
    )
    p_mid = delp / (peln[:, 1:] - peln[:, :-1])  # layer-mean pressure

    # --- thermodynamics: invert z(p), evaluate Tv and q
    r_a3 = np.broadcast_to(r_a[:, None], p_mid.shape)
    z_mid = _heights_of_pressure(r_a3, p_mid)
    tv = virtual_temperature(r_a3, z_mid)
    qv = specific_humidity(z_mid)
    pt = tv / pkz  # virtual potential temperature

    # --- winds on the D grid (covariant projections of the physical wind)
    u = np.empty((S, npz) + mt.xyz_u.shape[1:3])
    v = np.empty((S, npz) + mt.xyz_v.shape[1:3])
    for name, xyz, basis, out in (
        ("u", mt.xyz_u, mt.es1, u),
        ("v", mt.xyz_v, mt.ew2, v),
    ):
        lon_s, lat_s = lon_lat(xyz)
        r_s, tan_e, tan_n = _radius_and_azimuth(lon_s, lat_s)
        east = np.stack(
            [-np.sin(lon_s), np.cos(lon_s), np.zeros_like(lon_s)], axis=-1
        )
        north = np.stack(
            [
                -np.sin(lat_s) * np.cos(lon_s),
                -np.sin(lat_s) * np.sin(lon_s),
                np.cos(lat_s),
            ],
            axis=-1,
        )
        ps_s = P00 - DELTA_P * np.exp(-((r_s / R_P) ** 1.5))
        pe_s = ak[None, :, None, None] + bk[None, :, None, None] * ps_s[:, None]
        peln_s = np.log(pe_s)
        pmid_s = (pe_s[:, 1:] - pe_s[:, :-1]) / (peln_s[:, 1:] - peln_s[:, :-1])
        r_s3 = np.broadcast_to(r_s[:, None], pmid_s.shape)
        z_s = _heights_of_pressure(r_s3, pmid_s)
        vt = tangential_wind(r_s3, z_s)
        wind_cart = vt[..., None] * (
            tan_e[:, None, ..., None] * east[:, None]
            + tan_n[:, None, ..., None] * north[:, None]
        )
        out[:] = np.sum(wind_cart * basis[:, None], axis=-1)

    phis = np.zeros_like(ps)
    return dict(
        u=u, v=v, delp=delp, pt=pt, phis=phis, ps=ps, qvapor=qv
    )
