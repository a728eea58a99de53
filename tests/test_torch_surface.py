"""The port's interactive surface against pace_tpu's.

``build_surface`` of ``pace_tpu_torch.models.shield.surface`` for the
``land``, ``seaice`` and ``mixed`` types (with field overrides of the LSM and
sea-ice configs) against ``pace_tpu``'s: the resolved configs, the initial
``SurfaceState``, two ``step`` calls in a row on the forcing of the moist
baroclinic-wave state's lowest level at C12 (``Physics._surface_forcing``,
radiation and precipitation from a seed), the radiative skin and the
diagnostics (NaN where the mixed type's scheme is inactive), float64.
Tolerance: rtol 1e-12 with atol 1e-12 of each field's largest reference
value. The ``mixed`` land mask falls on the same points as ``pace_tpu``'s
and as |lat| <= land_lat_max on the grid; the scheme keeps ``pace_tpu``'s
tuple indexing; unknown types are errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.shield import surface as jsurf
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import surface as tsurf
from pace_tpu_torch.models.shield.physics import Physics

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0

CASES = {
    "land": dict(type="land", t_init=290.0, smc_init=0.2, lsm={"z0": 0.05}),
    "seaice": dict(type="seaice", t_init=268.0, h_ice_init=0.5,
                   seaice={"slab_ocean": True, "mixed_layer_depth": 20}),
    "mixed": dict(type="mixed", land_lat_max=35.0, t_init=285.0, smc_init=0.3),
    "earthlike": dict(type="mixed", land_lat_max=55.0, t_init=288.0, smc_init=0.25),
}


@pytest.fixture(scope="module")
def setup():
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    rng = np.random.default_rng(7)
    shape = tuple(st.ps.shape)
    forcing = Physics(case.grid, (), DT)._surface_forcing(
        st, torch.from_numpy(rng.uniform(0.0, 900.0, shape)),
        torch.from_numpy(rng.uniform(200.0, 400.0, shape)),
        tsurf.SurfaceState(precip=torch.zeros(shape, dtype=torch.float64)))
    forcing = {k: v.numpy().copy() for k, v in forcing.items() if k != "precip"}
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    return dict(tgrid=case.grid, jgrid=JGridData.from_metric_terms(mt, dtype=jnp.float64),
                forcing=forcing, shape=shape)


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    ok = ~np.isnan(want)
    assert np.isfinite(got[ok]).all(), name
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=RTOL * np.abs(want[ok]).max(),
                               err_msg=name)


def _states(sfc):
    """The SurfaceState's fields by name ("precip", "lsm.tskin", ...)."""
    out = {"precip": sfc.precip}
    for part in ("lsm", "ice"):
        sub = getattr(sfc, part)
        if sub is not None:
            out.update({f"{part}.{f.name}": getattr(sub, f.name) for f in dataclasses.fields(sub)})
    return out


def test_state_fields_are_pace_tpu_s():
    assert [f.name for f in dataclasses.fields(tsurf.SurfaceState)] == \
        [f.name for f in dataclasses.fields(jsurf.SurfaceState)]
    assert tsurf.build_surface(tsurf.SurfaceConfig()) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_surface_scheme_matches_over_two_steps(setup, name):
    tcfg, jcfg = tsurf.SurfaceConfig(**CASES[name]), jsurf.SurfaceConfig(**CASES[name])
    tgrid, jgrid = setup["tgrid"], setup["jgrid"]
    ts = tsurf.build_surface(tcfg, grid=lambda: tgrid)
    js = jsurf.build_surface(jcfg, grid=lambda: jgrid)
    # the resolved scheme configs, and pace_tpu's tuple form
    cfgs = ts.cfg if isinstance(ts.cfg, tuple) else (ts.cfg,)
    jcfgs = js.cfg if isinstance(js.cfg, tuple) else (js.cfg,)
    assert [dataclasses.asdict(c) for c in cfgs] == [dataclasses.asdict(c) for c in jcfgs]
    assert list(ts) == [ts.cfg, ts.init, ts.step, ts.tskin] and ts[3] is ts.tskin
    t_sfc = ts.init(setup["shape"], torch.float64, device="cpu")
    j_sfc = js.init(setup["shape"], jnp.float64)
    for k, v in _states(j_sfc).items():
        np.testing.assert_array_equal(_states(t_sfc)[k].numpy(), np.asarray(v), err_msg=k)
    rng = np.random.default_rng(8)
    for step in range(2):
        f = dict(setup["forcing"])
        f["t1"] = f["t1"] - 25.0 * step  # the second step in freezing air
        prec = rng.uniform(0.0, 2e-3, setup["shape"])
        t_sfc = dataclasses.replace(t_sfc, precip=torch.from_numpy(prec))
        j_sfc = dataclasses.replace(j_sfc, precip=jnp.asarray(prec))
        t_in = {k: v.clone() for k, v in _states(t_sfc).items()}
        tf, t_sfc_new = ts.step({k: torch.from_numpy(v) for k, v in f.items()} | {
            "precip": t_sfc.precip}, t_sfc, DT)
        jf, j_sfc = js.step({k: jnp.asarray(v) for k, v in f.items()} | {
            "precip": j_sfc.precip}, j_sfc, DT)
        assert all(torch.equal(v, _states(t_sfc)[k]) for k, v in t_in.items())  # not written
        t_sfc = t_sfc_new
        assert sorted(tf) == sorted(jf)
        for k in jf:
            _close(tf[k], jf[k], f"{name} step {step} flux {k}")
        for k, v in _states(j_sfc).items():
            _close(_states(t_sfc)[k], v, f"{name} step {step} {k}")
        _close(ts.tskin(t_sfc), js.tskin(j_sfc), f"{name} tskin")
        td, jd = ts.diagnostics(t_sfc), js.diagnostics(j_sfc)
        assert sorted(td) == sorted(jd)
        for k in jd:
            _close(td[k], jd[k], f"{name} diagnostic {k}")


@pytest.mark.parametrize("lat_max", [35.0, 55.0])
def test_mixed_mask_is_the_latitude_band(setup, lat_max):
    cfg = tsurf.SurfaceConfig(type="mixed", land_lat_max=lat_max)
    sch = tsurf.build_surface(cfg, grid=setup["tgrid"])
    sfc = sch.init(setup["shape"], torch.float64, device="cpu")
    sfc.ice.tsfc.fill_(250.0)  # the ice skin tells the two apart
    land = (sch.tskin(sfc) == cfg.t_init).numpy()
    lat = setup["tgrid"].lat_agrid.numpy()
    np.testing.assert_array_equal(land, np.abs(lat) <= np.radians(lat_max) + 1e-12)
    jsch = jsurf.build_surface(jsurf.SurfaceConfig(type="mixed", land_lat_max=lat_max),
                               grid=setup["jgrid"])
    jsfc = jsch.init(setup["shape"], jnp.float64)
    jsfc.ice.tsfc = jnp.full(setup["shape"], 250.0)
    np.testing.assert_array_equal(land, np.asarray(jsch.tskin(jsfc)) == cfg.t_init)
    d = sch.diagnostics(sfc)
    h_ice = d["h_ice"].numpy()
    assert np.isnan(h_ice[land]).all() and not np.isnan(h_ice[~land]).any()
    assert np.isnan(d["soil_moisture"].numpy()[~land]).all()
    assert 0 < land.sum() < land.size


def test_errors():
    with pytest.raises(ValueError, match="unknown surface type"):
        tsurf.build_surface(tsurf.SurfaceConfig(type="ocean"))
    with pytest.raises(ValueError, match="needs the grid"):
        tsurf.build_surface(tsurf.SurfaceConfig(type="mixed"))
    from pace_tpu_torch.utils.registry import ConfigError

    with pytest.raises(ConfigError, match="unknown key"):
        tsurf.build_surface(tsurf.SurfaceConfig(type="land", lsm={"z_0": 0.1}))
