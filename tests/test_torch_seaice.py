"""The port's Semtner sea ice against pace_tpu's.

``SeaIceState.init`` and ``seaice_step`` of
``pace_tpu_torch.models.shield.seaice`` against their ``pace_tpu`` namesakes
(XLA, CPU) on the same numpy inputs, float64: the forcing of the moist
baroclinic-wave state's lowest level at C12 (``Physics._surface_forcing``)
with downward radiation and precipitation from a seed, and ice states seeded
near the scheme's thresholds without sitting on them: open water, ice just
below and just above ``h_min`` and thick ice, snow just below and above the
1e-4 m of a snowy albedo, surfaces a few K either side of the melting point,
mixed layers either side of the seawater freezing point. Fixed-SST and slab
ocean, two steps in a row. Tolerance: rtol 1e-12 with atol 1e-12 of each
output's largest reference value. Then the oracle properties of
``tests/main/test_seaice.py`` on the port's side.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import seaice as jice
from pace_tpu_torch import constants
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import seaice as tice
from pace_tpu_torch.models.shield.physics import Physics
from pace_tpu_torch.models.shield.surface import SurfaceState

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
STATE = ("h_ice", "h_snow", "tsfc", "sst")


def _pick(rng, shape, choices):
    """Each point from one of ``choices`` (callables of the shape), at
    random."""
    which = rng.integers(0, len(choices), shape)
    return sum(np.where(which == i, c(shape), 0.0) for i, c in enumerate(choices))


@pytest.fixture(scope="module")
def inputs():
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    rng = np.random.default_rng(5)
    shape = tuple(st.ps.shape)
    # the air over sea ice is cold: the lowest level cooled by 0-40 K
    st.pt = st.pt.clone()
    st.pt[:, -1] -= torch.from_numpy(rng.uniform(0.0, 40.0, shape)) / st.pkz[:, -1]
    precip = rng.uniform(0.0, 2e-3, shape) * (rng.random(shape) < 0.7)
    f = Physics(case.grid, (), DT)._surface_forcing(
        st, torch.from_numpy(rng.uniform(0.0, 700.0, shape)),
        torch.from_numpy(rng.uniform(150.0, 350.0, shape)),
        SurfaceState(precip=torch.from_numpy(precip)))
    h_min = tice.SeaIceConfig().h_min
    u = rng.uniform
    s = dict(
        h_ice=_pick(rng, shape, [lambda sh: np.zeros(sh), lambda sh: h_min * u(0.5, 0.99, sh),
                                 lambda sh: h_min * u(1.01, 3.0, sh),
                                 lambda sh: u(0.3, 3.0, sh)]),
        h_snow=_pick(rng, shape, [lambda sh: np.zeros(sh), lambda sh: u(0.5e-4, 0.99e-4, sh),
                                  lambda sh: u(1.01e-4, 3e-4, sh),
                                  lambda sh: u(0.01, 0.3, sh)]),
        tsfc=tice.T_MELT + u(-8.0, 3.0, shape),
        sst=tice.T_FREEZE_OCEAN + u(-0.5, 5.0, shape),
    )
    return {k: v.numpy().copy() for k, v in f.items()}, s


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_state_fields_and_constants_are_pace_tpu_s():
    assert [f.name for f in dataclasses.fields(tice.SeaIceState)] == list(STATE)
    for k in ("RHO_ICE", "RHO_SNOW", "RHO_WATER", "K_ICE", "K_SNOW", "T_FREEZE_OCEAN",
              "T_MELT"):
        assert getattr(tice, k) == getattr(jice, k), k


@pytest.mark.parametrize("kw", [{}, dict(h0=0.0, t0=285.0, sst0=276.5)])
def test_init_matches(kw):
    got = tice.SeaIceState.init((6, 5, 7), dtype=torch.float64, device="cpu", **kw)
    want = jice.SeaIceState.init((6, 5, 7), dtype=jnp.float64, **kw)
    for k in STATE:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


@pytest.mark.parametrize("cfg", [{}, dict(slab_ocean=True, mixed_layer_depth=5.0),
                                 dict(h_min=0.02, newton_iters=2, ocean_heat_flux=30.0)])
def test_seaice_step_matches_over_two_steps(inputs, cfg):
    f, s = inputs
    ts = tice.SeaIceState(**{k: torch.from_numpy(np.array(v)) for k, v in s.items()})
    js = jice.SeaIceState(**{k: jnp.asarray(v) for k, v in s.items()})
    before = {k: getattr(ts, k).clone() for k in STATE}
    for step in range(2):
        tf, ts_new = tice.seaice_step(**{k: torch.from_numpy(v) for k, v in f.items()},
                                      state=ts, dt=DT, cfg=tice.SeaIceConfig(**cfg))
        jf, js = jice.seaice_step(**{k: jnp.asarray(v) for k, v in f.items()}, state=js,
                                  dt=DT, cfg=jice.SeaIceConfig(**cfg))
        assert sorted(tf) == sorted(jf)
        for k in jf:
            _close(tf[k], jf[k], f"step {step} flux {k}")
        for k in STATE:
            _close(getattr(ts_new, k), getattr(js, k), f"step {step} {k}")
        if step == 0:
            assert all(torch.equal(getattr(ts, k), before[k]) for k in STATE)  # not written
        ts = ts_new
    assert float(ts.h_ice.min()) == 0.0 and float(ts.h_ice.max()) > 0.3  # open water, ice


# ----------------------------------------------------------------------
# oracle properties on the port's side (tests/main/test_seaice.py)
# ----------------------------------------------------------------------

def _uniform(t1, sw, qv1=0.001, precip=0.0, lw=200.0):
    vals = dict(t1=t1, qv1=qv1, wind1=5.0, z1=20.0, p_sfc=1.0e5, sw_dn=sw, lw_dn=lw,
                precip=precip)
    return {k: torch.full((3, 4), v, dtype=torch.float64) for k, v in vals.items()}


def _init(**kw):
    return tice.SeaIceState.init((3, 4), dtype=torch.float64, device="cpu", **kw)


def test_polar_night_grows_ice_and_summer_caps_the_surface():
    cfg = tice.SeaIceConfig()
    _, winter = tice.seaice_step(**_uniform(240.0, 0.0, qv1=2e-4, lw=150.0),
                                 state=_init(h0=1.0, t0=250.0), dt=3600.0, cfg=cfg)
    assert float((winter.h_ice - 1.0).min()) > 0.0
    fx, summer = tice.seaice_step(**_uniform(278.0, 600.0, qv1=0.004, lw=320.0),
                                  state=_init(h0=1.0, t0=272.0), dt=3600.0, cfg=cfg)
    assert float(summer.tsfc.max()) <= tice.T_MELT
    assert float((summer.h_ice - 1.0).max()) < 0.0  # surface melt thins the ice
    rho = (1.0e5 / (constants.RDGAS * 278.0 * (1.0 + constants.ZVIR * 0.004)))
    np.testing.assert_allclose((fx["sensible_heat_flux"] * rho * constants.CP_AIR).numpy(),
                               fx["shf"].numpy(), rtol=1e-12)


def test_open_water_freezes_and_slab_ocean_cools():
    _, frozen = tice.seaice_step(**_uniform(240.0, 0.0, qv1=2e-4, lw=150.0),
                                 state=_init(h0=0.0, t0=271.35), dt=3600.0,
                                 cfg=tice.SeaIceConfig(sst=271.35))
    assert float(frozen.h_ice.min()) > 0.0
    slab = tice.SeaIceConfig(slab_ocean=True, mixed_layer_depth=10.0)
    _, cooled = tice.seaice_step(**_uniform(250.0, 0.0, qv1=5e-4, lw=180.0),
                                 state=_init(h0=0.0, t0=280.0), dt=3600.0, cfg=slab)
    assert float((cooled.sst - 280.0).max()) < 0.0 and float(cooled.h_ice.max()) == 0.0
