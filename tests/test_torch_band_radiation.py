"""The port's multi-band radiation against pace_tpu's.

Every function of ``pace_tpu_torch.models.shield.band_radiation`` against its
``pace_tpu`` namesake (XLA, CPU) on the same numpy inputs: the columns of
the moist baroclinic-wave state at C12 npz=8 (``demos.physics_step``'s
tracer block, whose liquid and ice give the cloud optics), float64, and the
Planck fits bit for bit. Tolerance: rtol 1e-12 with atol 1e-12 of each
output's largest reference value. Then the oracle properties of
``tests/main/test_band_radiation.py`` on the port's side: the band fractions
partition unity, a realistic clear-sky OLR with a transparent window, 2xCO2
forcing > 0, the water-vapor greenhouse, clouds lowering OLR and surface SW,
and the column's energy closure with LW and SW.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import band_radiation as jband
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import band_radiation as tband

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0


@pytest.fixture(scope="module")
def cols():
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    q = pdemo.moist_tracers(st, seed=0)
    pe = st.pe.numpy()
    ix = TRACER_NAMES.index
    return dict(pt=st.pt.numpy(), pkz=st.pkz.numpy(), pe=pe, ps=st.ps.numpy(),
                delp=pe[:, 1:] - pe[:, :-1], p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]),
                qv=q[:, ix("qvapor")], qc=q[:, ix("qliquid")] + q[:, ix("qice")])


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_band_structure_and_fits_are_pace_tpu_s():
    assert tband.LW_EDGES == jband.LW_EDGES and tband.N_LW == jband.N_LW
    np.testing.assert_array_equal(tband._BAND_COEF, jband._BAND_COEF)  # bit for bit
    assert tband._BAND_COEF.dtype == jband._BAND_COEF.dtype


def test_planck_band_fractions_match(cols):
    t = cols["pt"] * cols["pkz"]
    _close(tband.planck_band_fractions(*_t(t)), jband.planck_band_fractions(*_j(t)))


@pytest.mark.parametrize("clouds", [False, True])
def test_lw_band_optical_depths_match(cols, clouds):
    c = cols
    args = (c["qv"], c["qc"] if clouds else None, c["p_mid"], c["delp"])
    _close(tband.lw_band_optical_depths(*_t(*args), tband.BandRadiationConfig()),
           jband.lw_band_optical_depths(*_j(*args), jband.BandRadiationConfig()))


def test_lw_band_fluxes_match(cols):
    c = cols
    t_lay = c["pt"] * c["pkz"]
    dtau = np.asarray(jband.lw_band_optical_depths(*_j(c["qv"], c["qc"], c["p_mid"],
                                                       c["delp"]), jband.BandRadiationConfig()))
    t_s = t_lay[:, -1] + 2.0
    for name, a, b in zip(("up", "down"), tband.lw_band_fluxes(*_t(t_lay, dtau, t_s)),
                          jband.lw_band_fluxes(*_j(t_lay, dtau, t_s))):
        _close(a, b, name)


@pytest.mark.parametrize("clouds", [False, True])
def test_sw_fluxes_match(cols, clouds):
    c = cols
    cosz = np.linspace(0.0, 1.0, c["ps"].size).reshape(c["ps"].shape)  # night to zenith
    args = (c["qv"], c["qc"] if clouds else None, c["delp"], cosz)
    got = tband.sw_fluxes(*_t(*args), tband.BandRadiationConfig())
    want = jband.sw_fluxes(*_j(*args), jband.BandRadiationConfig())
    for name, a, b in zip(("sw_dn", "toa"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("case", ["defaults", "clouds, surface, sun", "2xCO2"])
def test_band_radiation_step_fluxes_and_olr_match(cols, case):
    c = cols
    args = (c["pt"], c["pkz"], c["pe"], c["ps"])
    kw, cfg = dict(qv=None, qc=None, t_surf=None, cosz=None), {}
    if case != "defaults":
        kw.update(qv=c["qv"], qc=c["qc"])
    if case == "clouds, surface, sun":
        kw.update(t_surf=c["pt"][:, -1] * c["pkz"][:, -1] - 4.0,
                  cosz=np.linspace(0.0, 1.0, c["ps"].size).reshape(c["ps"].shape))
    if case == "2xCO2":
        cfg = dict(co2_ppmv=800.0)
    names = list(kw)
    got = tband.band_radiation_step_fluxes(*_t(*args), DT, tband.BandRadiationConfig(**cfg),
                                           **dict(zip(names, _t(*kw.values()))))
    want = jband.band_radiation_step_fluxes(*_j(*args), DT, jband.BandRadiationConfig(**cfg),
                                            **dict(zip(names, _j(*kw.values()))))
    for name, a, b in zip(("pt", "lw_dn_sfc", "sw_dn_sfc"), got, want):
        _close(a, b, f"{case} {name}")
    olr_kw = {k: v for k, v in kw.items() if k != "cosz"}
    _close(tband.olr(*_t(*args), tband.BandRadiationConfig(**cfg),
                     **dict(zip(olr_kw, _t(*olr_kw.values())))),
           jband.olr(*_j(*args), jband.BandRadiationConfig(**cfg),
                     **dict(zip(olr_kw, _j(*olr_kw.values())))), f"{case} olr")


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

def _midlat_column(K=30, Y=2, X=2, t_sfc=288.0, q0=0.01):
    """Moist hydrostatic column: T falling 6.5 K/km to a 210 K tropopause,
    vapor decaying with pressure cubed."""
    pe = np.linspace(20e2, 1000e2, K + 1)[None, :, None, None] * np.ones((1, 1, Y, X))
    p_mid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    t = np.maximum(210.0, t_sfc * (p_mid / 1000e2) ** 0.19)
    qv = q0 * (p_mid / 1000e2) ** 3
    pkz = (p_mid / constants.P_REF) ** constants.KAPPA
    return _t(t / pkz, pkz, pe, pe[:, -1], qv)


def _olr(cfg=None, qc=None, **kw):
    pt, pkz, pe, ps, qv = _midlat_column(**kw)
    return float(tband.olr(pt, pkz, pe, ps, cfg or tband.BandRadiationConfig(), qv=qv,
                           qc=qc)[0, 0, 0])


def test_planck_fractions_partition_unity():
    f = tband.planck_band_fractions(torch.linspace(160.0, 330.0, 30, dtype=torch.float64))
    assert f.shape == (tband.N_LW, 30)
    np.testing.assert_allclose(f.sum(dim=0).numpy(), 1.0, rtol=1e-12)
    assert float(f.min()) >= 0.0 and float(f[3, -1]) > float(f[3, 0])  # Wien


def test_clear_sky_olr_realistic_and_window_transparent():
    assert 180.0 < _olr() < 320.0
    pt, pkz, pe, ps, qv = _midlat_column()
    tau = tband.lw_band_optical_depths(qv, None, 0.5 * (pe[:, 1:] + pe[:, :-1]),
                                       pe[:, 1:] - pe[:, :-1], tband.BandRadiationConfig())
    tau_col = tau.sum(dim=-3)[..., 0, 0]
    assert float(tau_col[0][0]) > 5.0 * float(tau_col[2][0])


def test_co2_doubling_and_vapor_and_clouds_lower_olr():
    forcing = (_olr(tband.BandRadiationConfig(co2_ppmv=400.0))
               - _olr(tband.BandRadiationConfig(co2_ppmv=800.0)))
    assert 0.3 < forcing < 15.0
    assert _olr(q0=0.016) < _olr(q0=0.004) - 2.0
    pt, pkz, pe, ps, qv = _midlat_column()
    qc = torch.zeros_like(qv)
    qc[:, 18:22] = 2e-4  # a mid-level cloud
    assert _olr(qc=qc) < _olr() - 5.0
    cfg = tband.BandRadiationConfig()
    cosz = torch.full_like(ps, 0.5)
    clear, _ = tband.sw_fluxes(qv, None, pe[:, 1:] - pe[:, :-1], cosz, cfg)
    cloud, _ = tband.sw_fluxes(qv, qc, pe[:, 1:] - pe[:, :-1], cosz, cfg)
    assert float(cloud[0, -1, 0, 0]) < float(clear[0, -1, 0, 0]) - 20.0


def test_column_energy_closure():
    """cp/g * sum(dT dp) / dt equals the net flux into the top minus the net
    flux through the surface, LW and SW."""
    cfg = tband.BandRadiationConfig()
    pt, pkz, pe, ps, qv = _midlat_column()
    dt = 600.0
    pt2, _, _ = tband.band_radiation_step_fluxes(pt, pkz, pe, ps, dt, cfg, qv=qv)
    delp = pe[:, 1:] - pe[:, :-1]
    col_heat = (constants.CP_AIR / constants.GRAV * (pt2 - pt) * pkz * delp / dt).sum(dim=-3)
    t = pt * pkz
    dtau = tband.lw_band_optical_depths(qv, None, 0.5 * (pe[:, 1:] + pe[:, :-1]), delp, cfg)
    up, down = tband.lw_band_fluxes(t, dtau, t[..., -1, :, :])
    sw, _ = tband.sw_fluxes(qv, None, delp, torch.full_like(ps, cfg.cos_zenith_mean), cfg)
    net_toa = sw[:, 0] - (up - down)[:, 0]
    net_sfc = sw[:, -1] - (up - down)[:, -1]
    np.testing.assert_allclose(col_heat.numpy(), (net_toa - net_sfc).numpy(), rtol=1e-10)
