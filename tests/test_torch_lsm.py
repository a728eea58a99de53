"""The port's NOAH-style land surface model against pace_tpu's.

``_solve4_tridiag``, ``LSMState.init`` and ``lsm_step`` of
``pace_tpu_torch.models.shield.lsm`` against their ``pace_tpu`` namesakes
(XLA, CPU) on the same numpy inputs, float64: the forcing of the moist
baroclinic-wave state's lowest level at C12 (``Physics._surface_forcing``:
temperature, vapor, wind, height, surface pressure) with downward radiation
and precipitation from a seed, and land states seeded near the scheme's
thresholds without sitting on them: snow-free points beside thin and deep
snowpacks, skins a few K either side of freezing under air either side of
freezing, soil moisture from below the wilting point to near porosity, air
above and below saturation at the skin. Two steps in a row, so that the
second starts from a computed state. Tolerance: rtol 1e-12 with atol 1e-12
of each output's largest reference value. Then the oracle properties of
``tests/main/test_lsm.py`` on the port's side.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import lsm as jlsm
from pace_tpu_torch import constants
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import lsm as tlsm
from pace_tpu_torch.models.shield.microphysics import saturation_mixing_ratio
from pace_tpu_torch.models.shield.physics import Physics
from pace_tpu_torch.models.shield.surface import SurfaceState

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
STATE = ("tskin", "stc", "smc", "sneqv")


def _forcing(seed):
    """The surface forcing of the moist C12 state (numpy), radiation and
    precipitation from ``seed``."""
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    rng = np.random.default_rng(seed)
    shape = tuple(st.ps.shape)
    precip = rng.uniform(0.0, 2e-3, shape) * (rng.random(shape) < 0.7)
    f = Physics(case.grid, (), DT)._surface_forcing(
        st, torch.from_numpy(rng.uniform(0.0, 900.0, shape)),
        torch.from_numpy(rng.uniform(200.0, 400.0, shape)),
        SurfaceState(precip=torch.from_numpy(precip)))
    return {k: v.numpy().copy() for k, v in f.items()}


def _land_state(f, seed):
    """A land state near the thresholds (numpy)."""
    rng = np.random.default_rng(seed)
    shape = f["t1"].shape
    tskin = f["t1"] + rng.uniform(-4.0, 4.0, shape)
    stc = tskin[:, None] + rng.uniform(-3.0, 3.0, (shape[0], 4) + shape[1:])
    smc = rng.uniform(0.06, 0.44, stc.shape)
    sneqv = np.where(rng.random(shape) < 0.5, 0.0, rng.uniform(1e-5, 0.03, shape))
    return dict(tskin=tskin, stc=stc, smc=smc, sneqv=sneqv)


@pytest.fixture(scope="module")
def inputs():
    f = _forcing(1)
    # air around saturation at the skin: condensing and evaporating points
    s = _land_state(f, 2)
    qs = saturation_mixing_ratio(*[torch.from_numpy(s["tskin"]), torch.from_numpy(f["p_sfc"])])
    f["qv1"] = qs.numpy() * np.random.default_rng(3).uniform(0.5, 1.3, qs.shape)
    return f, s


def _tstate(s):
    return tlsm.LSMState(**{k: torch.from_numpy(np.array(v)) for k, v in s.items()})


def _jstate(s):
    return jlsm.LSMState(**{k: jnp.asarray(v) for k, v in s.items()})


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_state_fields_and_layers_are_pace_tpu_s():
    assert [f.name for f in dataclasses.fields(tlsm.LSMState)] == \
        [f.name for f in dataclasses.fields(jlsm.LSMState)]
    assert tlsm.SOIL_DZ == jlsm.SOIL_DZ


def test_init_matches():
    got = tlsm.LSMState.init((6, 5, 7), t0=281.5, smc0=0.3, dtype=torch.float64, device="cpu")
    want = jlsm.LSMState.init((6, 5, 7), t0=281.5, smc0=0.3, dtype=jnp.float64)
    for k in STATE:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
        assert getattr(got, k).dtype == torch.float64


def test_solve4_tridiag_matches_and_solves():
    rng = np.random.default_rng(4)
    shape = (2, 4, 3, 5)
    lo, up = rng.uniform(-0.5, -0.1, shape), rng.uniform(-0.5, -0.1, shape)
    di, rhs = 1.0 - lo - up, rng.standard_normal(shape)
    got = tlsm._solve4_tridiag(*[torch.from_numpy(a) for a in (lo, di, up, rhs)])
    _close(got, jlsm._solve4_tridiag(*[jnp.asarray(a) for a in (lo, di, up, rhs)]))
    x = got.numpy()
    for j in range(3):
        m = np.diag(di[0, :, j, 1]) + np.diag(lo[0, 1:, j, 1], -1) + np.diag(up[0, :-1, j, 1], 1)
        np.testing.assert_allclose(x[0, :, j, 1], np.linalg.solve(m, rhs[0, :, j, 1]),
                                   rtol=1e-12)


@pytest.mark.parametrize("cfg", [{}, dict(newton_iters=1, z0=0.5, snow_albedo_swe=0.02)])
def test_lsm_step_matches_over_two_steps(inputs, cfg):
    f, s = inputs
    ts, js = _tstate(s), _jstate(s)
    before = {k: getattr(ts, k).clone() for k in STATE}
    for step in range(2):
        tf, ts_new = tlsm.lsm_step(**{k: torch.from_numpy(v) for k, v in f.items()}, state=ts,
                                   dt=DT, cfg=tlsm.LSMConfig(**cfg))
        jf, js = jlsm.lsm_step(**{k: jnp.asarray(v) for k, v in f.items()}, state=js, dt=DT,
                               cfg=jlsm.LSMConfig(**cfg))
        assert sorted(tf) == sorted(jf)
        for k in jf:
            _close(tf[k], jf[k], f"step {step} flux {k}")
        for k in STATE:
            _close(getattr(ts_new, k), getattr(js, k), f"step {step} {k}")
        if step == 0:
            assert all(torch.equal(getattr(ts, k), before[k]) for k in STATE)  # not written
        ts = ts_new
    # the seeded state reaches each branch
    assert float(tf["snowmelt"].max()) > 0.0 and float(ts.sneqv.min()) == 0.0
    assert float(tf["evap"].min()) == 0.0 and float(tf["evap"].max()) > 0.0


# ----------------------------------------------------------------------
# oracle properties on the port's side (tests/main/test_lsm.py)
# ----------------------------------------------------------------------

Y, X = 3, 4


def _uniform(t1=295.0, qv1=0.008, sw=600.0, precip=0.0):
    vals = dict(t1=t1, qv1=qv1, wind1=4.0, z1=50.0, p_sfc=1.0e5, sw_dn=sw, lw_dn=350.0,
                precip=precip)
    return {k: torch.full((Y, X), v, dtype=torch.float64) for k, v in vals.items()}


def _init(t0, smc0=0.25):
    return tlsm.LSMState.init((Y, X), t0=t0, smc0=smc0, dtype=torch.float64, device="cpu")


def test_energy_balance_closes_and_soil_heat_is_conserved():
    cfg = tlsm.LSMConfig()
    state = _init(290.0)
    stc = state.stc.clone()
    stc[0], stc[2] = 296.0, 284.0
    state = dataclasses.replace(state, stc=stc)
    fx, new = tlsm.lsm_step(**_uniform(), state=state, dt=600.0, cfg=cfg)
    resid = fx["net_radiation"] - fx["shf"] - fx["lhf"] - fx["ground"]
    assert float(resid.abs().max()) < 0.5  # W/m^2, the Newton residual
    dz = torch.tensor(tlsm.SOIL_DZ, dtype=torch.float64).view(4, 1, 1)
    de = cfg.soil_heat_capacity * ((new.stc - state.stc) * dz).sum(dim=0)
    np.testing.assert_allclose(de.numpy(), 600.0 * fx["ground"].numpy(), rtol=1e-10)


def test_dry_soil_and_rain_and_runoff():
    cfg = tlsm.LSMConfig()
    fx_wet, _ = tlsm.lsm_step(**_uniform(), state=_init(290.0, 0.35), dt=600.0, cfg=cfg)
    fx_dry, _ = tlsm.lsm_step(**_uniform(), state=_init(290.0, cfg.smcwlt), dt=600.0, cfg=cfg)
    assert float(fx_dry["lhf"].max()) == 0.0 and float(fx_wet["lhf"].min()) > 10.0
    rain = _uniform(t1=285.0, sw=100.0, precip=5e-3)
    _, new = tlsm.lsm_step(**rain, state=_init(285.0, 0.2), dt=600.0, cfg=cfg)
    assert float((new.smc[0] - 0.2).min()) > 0.0 and float(new.sneqv.max()) == 0.0
    _, sat = tlsm.lsm_step(**rain, state=_init(285.0, cfg.smcmax), dt=600.0, cfg=cfg)
    assert float(sat.smc.max()) <= cfg.smcmax


def test_snow_accumulates_caps_the_skin_and_melts():
    cfg = tlsm.LSMConfig()
    _, snowy = tlsm.lsm_step(**_uniform(t1=265.0, qv1=0.002, sw=50.0, precip=2e-3),
                             state=_init(268.0), dt=600.0, cfg=cfg)
    assert float(snowy.sneqv.min()) > 0.0
    fx, melted = tlsm.lsm_step(**_uniform(t1=280.0, qv1=0.005, sw=900.0), state=snowy,
                               dt=600.0, cfg=cfg)
    assert float(melted.tskin.max()) <= constants.TICE
    assert float((snowy.sneqv - melted.sneqv).min()) > 0.0
    assert float(fx["snowmelt"].min()) > 0.0
    np.testing.assert_allclose(fx["lhf"].numpy(),
                               (constants.HLV + constants.HLF) * fx["evap"].numpy(), rtol=1e-12)


def test_kinematic_fluxes_consistent():
    f = _uniform()
    fx, _ = tlsm.lsm_step(**f, state=_init(292.0, 0.3), dt=600.0, cfg=tlsm.LSMConfig())
    rho = f["p_sfc"] / (constants.RDGAS * f["t1"] * (1.0 + constants.ZVIR * f["qv1"]))
    np.testing.assert_allclose((fx["sensible_heat_flux"] * rho * constants.CP_AIR).numpy(),
                               fx["shf"].numpy(), rtol=1e-12)
    np.testing.assert_allclose((fx["latent_heat_flux"] * rho * constants.HLV).numpy(),
                               fx["lhf"].numpy(), rtol=1e-12)
