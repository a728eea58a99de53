"""The port's gray radiation against pace_tpu's.

Every function of ``pace_tpu_torch.models.shield.radiation`` against its
``pace_tpu`` namesake (XLA, CPU) on the same numpy inputs: the columns of
the moist baroclinic-wave state at C12 npz=8 (``demos.physics_step``'s
tracer block), float64. The insolation is held against ``pace_tpu``'s as its
jitted ``Physics`` computes it, from a float32 model time: the annual-mean
profile, the diurnal cycle and the seasonal declination at several times.
Tolerance: rtol 1e-12 with atol 1e-12 of each output's largest reference
value. Then the oracle properties of ``tests/main/test_radiation.py`` on the
port's side: column energy closure, an isothermal column cooling to space,
a hot surface warming the lowest layer, monotone optical depths, moist
columns more opaque, the diurnal and seasonal insolation's limits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import radiation as jrad
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import radiation as trad

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
#: model times [s]: the start, a step, local noon at lon 0, near the
#: northern summer solstice, a year on, none of them a float32 number
#: after 1e7
TIMES = (0.0, 200.0, 43200.0, 1.5e7 + 123.4, 3.2e7 + 0.7)


@pytest.fixture(scope="module")
def cols():
    """Numpy columns of the moist baroclinic-wave state and the grid's
    latitude fields."""
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    q = pdemo.moist_tracers(st, seed=0)
    sinlat = np.clip(case.grid.f0.numpy() / (2.0 * constants.OMEGA), -1.0, 1.0)
    pe = st.pe.numpy()
    return dict(pt=st.pt.numpy(), pkz=st.pkz.numpy(), pe=pe, ps=st.ps.numpy(),
                delp=pe[:, 1:] - pe[:, :-1], qv=q[:, TRACER_NAMES.index("qvapor")],
                sinlat2=sinlat * sinlat, lat=case.grid.lat_agrid.numpy(),
                lon=case.grid.lon_agrid.numpy(), f0=case.grid.f0.numpy())


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_sin_latitude_is_pace_tpu_s_jitted_division(cols):
    """``f0 / (2 Omega)`` in pace_tpu's jitted physics is a multiply by the
    reciprocal: the port's latitudes are the same bits."""
    got = trad.sin_latitude(*_t(cols["f0"])).numpy()
    want = np.asarray(jax.jit(lambda f: jnp.clip(f / (2.0 * constants.OMEGA), -1.0, 1.0))(
        cols["f0"]))
    np.testing.assert_array_equal(got, want)
    assert trad.SIGMA_SB == jrad.SIGMA_SB


@pytest.mark.parametrize("kind", ["prescribed", "interactive"])
def test_optical_depth_matches(cols, kind):
    c = cols
    if kind == "prescribed":
        args = (c["pe"], c["ps"], c["sinlat2"])
        got = trad.optical_depth(*_t(*args), trad.GrayRadiationConfig())
        want = jrad.optical_depth(*_j(*args), jrad.GrayRadiationConfig())
    else:
        cfg = dict(interactive_vapor=True)
        got = trad.optical_depth_interactive(*_t(c["qv"], c["delp"]),
                                             trad.GrayRadiationConfig(**cfg))
        want = jrad.optical_depth_interactive(*_j(c["qv"], c["delp"]),
                                              jrad.GrayRadiationConfig(**cfg))
    _close(got, want, kind)
    assert (np.diff(got.numpy(), axis=-3) > 0).all()  # increases downward


@pytest.mark.parametrize("t_surf", ["number", "field"])
def test_lw_fluxes_match(cols, t_surf):
    c = cols
    t_lay = c["pt"] * c["pkz"]
    tau = np.asarray(jrad.optical_depth(*_j(c["pe"], c["ps"], c["sinlat2"]),
                                        jrad.GrayRadiationConfig()))
    ts = 291.5 if t_surf == "number" else t_lay[:, -1] + np.linspace(-5, 5, t_lay[:, -1].size
                                                                      ).reshape(c["ps"].shape)
    got = trad.lw_fluxes(*_t(t_lay, tau), ts if t_surf == "number" else _t(ts)[0])
    want = jrad.lw_fluxes(*_j(t_lay, tau), ts if t_surf == "number" else jnp.asarray(ts))
    for name, a, b in zip(("up", "down"), got, want):
        _close(a, b, name)
    assert float(got[1][:, 0].abs().max()) == 0.0  # no downwelling at the top


def test_sw_surface_and_annual_mean_insolation_match(cols):
    s2 = cols["sinlat2"]
    cfg_t, cfg_j = trad.GrayRadiationConfig(), jrad.GrayRadiationConfig()
    _close(trad.sw_surface(*_t(s2), cfg_t), jrad.sw_surface(*_j(s2), cfg_j), "sw_surface")
    _close(trad.sw_down_surface(*_t(s2), cfg_t), jrad.sw_down_surface(*_j(s2), cfg_j),
           "sw_down_surface")
    # without the diurnal switch, the time arguments change nothing
    got = trad.sw_down_surface(*_t(s2), cfg_t, *_t(cols["lat"], cols["lon"]), 1234.0)
    np.testing.assert_array_equal(got.numpy(), trad.sw_down_surface(*_t(s2), cfg_t).numpy())


@pytest.mark.parametrize("seasonal", [False, True])
@pytest.mark.parametrize("time_seconds", TIMES)
def test_diurnal_insolation_matches_pace_tpu_s_float32_time(cols, seasonal, time_seconds):
    kw = dict(diurnal=True, seasonal=seasonal, declination_deg=10.0)
    s2, lat, lon = cols["sinlat2"], cols["lat"], cols["lon"]
    got = trad.sw_down_surface(*_t(s2), trad.GrayRadiationConfig(**kw), *_t(lat, lon),
                               time_seconds)
    # pace_tpu's Physics holds the time as float32 and jits the call
    jfn = jax.jit(functools.partial(jrad.sw_down_surface, cfg=jrad.GrayRadiationConfig(**kw)))
    want = jfn(jnp.asarray(s2), lat=jnp.asarray(lat), lon=jnp.asarray(lon),
               time_seconds=jnp.asarray(time_seconds, dtype=jnp.float32))
    _close(got, want, f"seasonal={seasonal} t={time_seconds}")
    assert float(got.max()) > 0.0 and float(got.min()) == 0.0  # day and night


@pytest.mark.parametrize("case", ["prescribed", "surface field", "interactive vapor",
                                  "interactive without qv"])
def test_gray_radiation_step_fluxes_match(cols, case):
    c = cols
    kw, t_surf, qv = {}, None, None
    if case == "surface field":
        t_surf = c["pt"][:, -1] * c["pkz"][:, -1] + 3.0
    if case.startswith("interactive"):
        kw = dict(interactive_vapor=True)
        qv = c["qv"] if case == "interactive vapor" else None
    args = (c["pt"], c["pkz"], c["pe"], c["ps"], c["sinlat2"])
    opt = lambda conv: dict(t_surf=None if t_surf is None else conv(t_surf)[0],  # noqa: E731
                            qv=None if qv is None else conv(qv)[0])
    got = trad.gray_radiation_step_fluxes(*_t(*args), DT, trad.GrayRadiationConfig(**kw),
                                          **opt(_t))
    want = jrad.gray_radiation_step_fluxes(*_j(*args), DT, jrad.GrayRadiationConfig(**kw),
                                           **opt(_j))
    for name, a, b in zip(("pt", "lw_dn_sfc"), got, want):
        _close(a, b, f"{case} {name}")
    if case == "prescribed":
        _close(trad.gray_radiation_step(*_t(*args), DT, trad.GrayRadiationConfig()),
               jrad.gray_radiation_step(*_j(*args), DT, jrad.GrayRadiationConfig()), "step")


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

S, K, Y, X = 2, 16, 4, 4


def _column():
    pe = np.linspace(100.0, 1.0e5, K + 1)[None, :, None, None] * np.ones((S, 1, Y, X))
    return _t(np.full((S, K, Y, X), 280.0), pe, np.full((S, Y, X), 1.0e5),
              np.full((S, Y, X), 0.25))


def test_energy_closure():
    """Column-integrated heating equals the net flux convergence."""
    t, pe, ps, s2 = _column()
    cfg = trad.GrayRadiationConfig()
    up, down = trad.lw_fluxes(t, trad.optical_depth(pe, ps, s2, cfg), cfg.t_surf)
    net = (up - down).numpy()
    dt = 600.0
    dT = (trad.gray_radiation_step(t, torch.ones_like(t), pe, ps, s2, dt, cfg) - t).numpy()
    dp = (pe[:, 1:] - pe[:, :-1]).numpy()
    col_heat = (constants.CP_AIR / constants.GRAV * dT * dp / dt).sum(axis=1)
    np.testing.assert_allclose(col_heat, net[:, -1] - net[:, 0], rtol=1e-10)


def test_isothermal_column_cools_to_space_and_hot_surface_warms():
    t, pe, ps, s2 = _column()
    one = torch.ones_like(t)
    dT = trad.gray_radiation_step(t, one, pe, ps, s2, 600.0,
                                  trad.GrayRadiationConfig(t_surf=280.0)) - t
    assert float(dT.sum()) < 0.0  # emission to space, nothing comes in
    assert float(dT.abs().max()) < 10.0 / 144.0  # well under 10 K/day
    hot = trad.gray_radiation_step(t, one, pe, ps, s2, 600.0,
                                   trad.GrayRadiationConfig(t_surf=330.0))
    assert bool((hot[:, -1] > t[:, -1]).all())


def test_thick_isothermal_column_is_a_blackbody():
    t, pe, ps, s2 = _column()
    cfg = trad.GrayRadiationConfig(t_surf=280.0)
    up, down = trad.lw_fluxes(t, trad.optical_depth(pe, ps, s2, cfg) * 50.0, cfg.t_surf)
    b = trad.SIGMA_SB * 280.0**4
    np.testing.assert_allclose(up[:, -1].numpy(), b, rtol=1e-12)
    np.testing.assert_allclose(down[:, -2].numpy(), b, rtol=1e-3)


def test_moist_columns_are_more_opaque():
    Kv, Yv, Xv = 20, 2, 3
    pe = np.broadcast_to(np.linspace(2000.0, 1.0e5, Kv + 1)[:, None, None], (Kv + 1, Yv, Xv))
    p_mid = 0.5 * (pe[1:] + pe[:-1])
    pkz = (p_mid / 1.0e5) ** (2.0 / 7.0)
    pt = 300.0 * (p_mid / 1.0e5) ** 0.22 / pkz
    moist = 0.018 * (p_mid / 1.0e5) ** 3
    cfg = trad.GrayRadiationConfig(interactive_vapor=True)
    tau_m = trad.optical_depth_interactive(*_t(moist, pe[1:] - pe[:-1]), cfg)
    tau_d = trad.optical_depth_interactive(*_t(0.1 * moist, pe[1:] - pe[:-1]), cfg)
    assert float(tau_m[-1].min()) > float(tau_d[-1].max())
    args = _t(pt, pkz, pe, pe[-1], np.zeros((Yv, Xv)))
    _, lw_m = trad.gray_radiation_step_fluxes(*args, 600.0, cfg, qv=_t(moist)[0])
    _, lw_d = trad.gray_radiation_step_fluxes(*args, 600.0, cfg, qv=_t(0.1 * moist)[0])
    assert float(lw_m.min()) > float(lw_d.max())


def test_diurnal_and_seasonal_limits():
    cfg = trad.GrayRadiationConfig(diurnal=True)
    z = torch.zeros((2, 3), dtype=torch.float64)
    noon = trad.sw_down_surface(z, cfg, z, z, 43200.0)
    np.testing.assert_allclose(noon.numpy(), cfg.solar_constant, rtol=1e-6)
    assert float(trad.sw_down_surface(z, cfg, z, z, 0.0).abs().max()) < 1e-9
    far = trad.sw_down_surface(z, cfg, z, z + np.pi, 0.0)
    assert float(far.min()) > 0.9 * cfg.solar_constant
    # seasonal: polar night in early January, midnight sun half a year on
    cfg = trad.GrayRadiationConfig(diurnal=True, seasonal=True)
    lat = torch.full((1, 1), np.radians(80.0), dtype=torch.float64)
    lon = torch.zeros((1, 1), dtype=torch.float64)

    def daily_mean(t0):
        ts = [t0 + f * cfg.day_length for f in np.linspace(0, 1, 25)[:-1]]
        return sum(float(trad.sw_down_surface(lon, cfg, lat, lon, t).mean()) for t in ts) / 24

    assert daily_mean(0.0) < 1.0
    assert daily_mean(cfg.year_length / 2.0) > 100.0
    assert trad.sw_surface(0.0, cfg) > trad.sw_surface(1.0, cfg)
