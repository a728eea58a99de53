"""The port's GFDL microphysics against pace_tpu's.

Every function of ``pace_tpu_torch.models.shield.microphysics`` against its
``pace_tpu`` namesake (XLA, CPU) on the same numpy inputs: the layer
temperature, mid-layer pressure and thickness of the baroclinic-wave state
at C12 npz=8 with the tracer block of ``demos.physics_step.moist_tracers``
(vapor between 0.3 and 1.1 of saturation, small condensates), float64.
``microphysics_step`` runs with each structural switch as a case of one
test. Tolerance: rtol 1e-12 with atol 1e-12 of each output's largest
reference value. Then the oracle properties of
``tests/main/test_microphysics_gfdl.py`` and ``tests/main/test_physics.py``
on the port's side: water and moist enthalpy conserved by each process,
sedimentation precipitating and conserving the column.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu import constants as jconstants
from pace_tpu.models.shield import microphysics as jmp
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import microphysics as tmp

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
SPECIES = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")
CP, LV, LF = constants.CP_AIR, constants.HLV, constants.HLF


@pytest.fixture(scope="module")
def cols():
    """Numpy layer fields of the moist baroclinic-wave state: the six
    species, temperature t, mid-layer pressure p, delp, and a land
    fraction."""
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    q = pdemo.moist_tracers(st, seed=0)
    out = {name: q[:, TRACER_NAMES.index(name)] for name in SPECIES}
    pe = st.pe.numpy()
    out["p"] = 0.5 * (pe[:, 1:] + pe[:, :-1])
    out["t"] = st.pt.numpy() * st.pkz.numpy() / (1.0 + constants.ZVIR * out["qvapor"])
    out["delp"] = st.delp.numpy()
    out["land"] = np.random.default_rng(1).random(out["t"][:, 0].shape)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, name=""):
    if want is None:
        assert got is None, name
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def _args(cols, *names):
    return [cols[n] for n in names]


def test_constants_are_pace_tpu_s():
    for name in ("T_FREEZE", "T_WFR", "QMIN", "RHO_SFC", "_NORM_RAIN", "_NORM_SNOW",
                 "_NORM_GRAUPEL"):
        assert getattr(tmp, name) == pytest.approx(float(getattr(jmp, name)), rel=1e-15), name
    assert tmp._NORM_RAIN == math.pi * 1000.0 * 8.0e6


@pytest.mark.parametrize("fn", ["saturation_vapor_pressure", "saturation_vapor_pressure_ice",
                                "saturation_mixing_ratio", "saturation_mixing_ratio_ice",
                                "d_saturation_mixing_ratio_dt",
                                "d_saturation_mixing_ratio_ice_dt"])
def test_saturation_thermodynamics_match(cols, fn):
    # the whole clipped range of the fits: 150 K to 340 K
    t = np.linspace(150.0, 340.0, cols["t"].size).reshape(cols["t"].shape)
    args = (t,) if fn.startswith("saturation_vapor") else (t, cols["p"])
    _close(getattr(tmp, fn)(*_t(*args)), getattr(jmp, fn)(*_j(*args)), fn)


@pytest.mark.parametrize("dt,tau", [(100.0, 150.0), (200.0, 21600.0), (75.0, 3600.0)])
def test_frac_matches(dt, tau):
    assert tmp._frac(dt, tau) == pytest.approx(float(jmp._frac(dt, tau)), rel=1e-15)


@pytest.mark.parametrize("over", [
    {}, {"do_qa": False}, {"icloud_f": 1}, {"land": True},
    {"tau_v2l": 90.0, "ql_gen": 2e-4, "qi_lim": 0.5},
])
def test_fast_saturation_adjustment_matches(cols, over):
    over = dict(over)
    land = cols["land"] if over.pop("land", False) else None
    args = _args(cols, *SPECIES, "t", "p")
    want = jmp.fast_saturation_adjustment(*_j(*args), DT, jmp.MicrophysicsConfig(**over),
                                          land=None if land is None else jnp.asarray(land))
    got = tmp.fast_saturation_adjustment(*_t(*args), DT, tmp.MicrophysicsConfig(**over),
                                         land=None if land is None else torch.from_numpy(land))
    for name, a, b in zip(SPECIES + ("t", "qa"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("with_land", [False, True])
def test_warm_rain_processes_match(cols, with_land):
    args = _args(cols, "qvapor", "qliquid", "qrain", "t", "p")
    land = cols["land"] if with_land else None
    want = jmp.warm_rain_processes(*_j(*args), DT, jmp.MicrophysicsConfig(),
                                   land=None if land is None else jnp.asarray(land))
    got = tmp.warm_rain_processes(*_t(*args), DT, tmp.MicrophysicsConfig(),
                                  land=None if land is None else torch.from_numpy(land))
    for name, a, b in zip(("qvapor", "qliquid", "qrain", "t"), got, want):
        _close(a, b, name)


def test_cold_processes_match(cols):
    args = _args(cols, *SPECIES, "t", "p")
    want = jmp.cold_processes(*_j(*args), DT, jmp.MicrophysicsConfig())
    got = tmp.cold_processes(*_t(*args), DT, tmp.MicrophysicsConfig())
    for name, a, b in zip(SPECIES + ("t",), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("law,species", [("rain", "qrain"), ("snow", "qsnow"),
                                         ("graupel", "qgraupel"), ("ice", "qice")])
@pytest.mark.parametrize("const", [False, True])
def test_fall_speed_laws_match(cols, law, species, const):
    flag = {"rain": "const_vr", "snow": "const_vs", "graupel": "const_vg", "ice": "const_vi"}
    kw = {flag[law]: const}
    t, p, q = cols["t"], cols["p"], cols[species]
    rho = p / (constants.RDGAS * np.maximum(t, 100.0))
    fn = f"fall_speed_{law}"
    _close(getattr(tmp, fn)(*_t(q, rho), tmp.MicrophysicsConfig(**kw)),
           getattr(jmp, fn)(*_j(q, rho), jmp.MicrophysicsConfig(**kw)), fn)


def test_sediment_matches(cols):
    t, p, q, delp = cols["t"], cols["p"], cols["qrain"], cols["delp"]
    rho = p / (constants.RDGAS * np.maximum(t, 100.0))
    vfall = np.asarray(jmp.fall_speed_rain(jnp.asarray(q), jnp.asarray(rho),
                                           jmp.MicrophysicsConfig()))
    want = jmp._sediment(*_j(q, delp, vfall, t, p), DT)
    got = tmp._sediment(*_t(q, delp, vfall, t, p), DT)
    for name, a, b in zip(("q", "precip"), got, want):
        _close(a, b, name)
    # a constant fall speed broadcasts over the column
    _close(tmp._sediment(*_t(q, delp), 2.0, *_t(t, p), DT)[0],
           jmp._sediment(*_j(q, delp), 2.0, *_j(t, p), DT)[0], "constant speed")


def test_sedi_heat_matches(cols):
    q0, t, delp = cols["qsnow"], cols["t"], cols["delp"]
    q1 = q0 * np.random.default_rng(2).uniform(0.5, 1.5, q0.shape)
    _close(tmp._sedi_heat(*_t(q0, q1, t, delp), 1972.0),
           jmp._sedi_heat(*_j(q0, q1, t, delp), 1972.0), "t")


@pytest.mark.parametrize("sedi_heat", [False, True])
def test_terminal_fall_matches(cols, sedi_heat):
    args = _args(cols, "qice", "qrain", "qsnow", "qgraupel", "t", "p", "delp")
    want = jmp.terminal_fall(*_j(*args), DT, jmp.MicrophysicsConfig(do_sedi_heat=sedi_heat))
    got = tmp.terminal_fall(*_t(*args), DT, tmp.MicrophysicsConfig(do_sedi_heat=sedi_heat))
    for name, a, b in zip(("qice", "qrain", "qsnow", "qgraupel", "t"), got[:5], want[:5]):
        _close(a, b, name)
    for name, a, b in zip(("pr", "pi", "ps", "pg"), got[5], want[5]):
        _close(a, b, name)


def test_warm_only_adjust_matches(cols):
    args = _args(cols, *SPECIES, "t", "p")
    want = jmp._warm_only_adjust(*_j(*args), DT, jmp.MicrophysicsConfig())
    got = tmp._warm_only_adjust(*_t(*args), DT, tmp.MicrophysicsConfig())
    for name, a, b in zip(SPECIES + ("t", "qa"), got, want):
        _close(a, b, name)


#: microphysics_step's structural switches, one case each
STEP_CASES = {
    "default": {},
    "no_ice": {"do_ice": False},
    "no_warm_rain": {"do_warm_rain": False},
    "no_sedimentation": {"do_sedimentation": False},
    "sedi_heat": {"do_sedi_heat": True},
    "const_v": {"const_vi": True, "const_vr": True, "const_vs": True, "const_vg": True,
                "vr_fac": 4.0, "vs_fac": 1.5, "vg_fac": 2.5, "vi_fac": 0.3},
    "dt_split": {"dt_split": 3},
    "one_substep": {"mp_time": 600.0},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_microphysics_step_matches(cols, case):
    args = _args(cols, *SPECIES, "t", "p", "delp")
    want = jmp.microphysics_step(*_j(*args), DT, jmp.MicrophysicsConfig(**STEP_CASES[case]))
    got = tmp.microphysics_step(*_t(*args), DT, tmp.MicrophysicsConfig(**STEP_CASES[case]))
    for name, a, b in zip(SPECIES + ("t", "precip"), got, want):
        _close(a, b, f"{case} {name}")


def test_microphysics_step_with_land_matches(cols):
    args = _args(cols, *SPECIES, "t", "p", "delp")
    want = jmp.microphysics_step(*_j(*args), DT, land=jnp.asarray(cols["land"]))
    got = tmp.microphysics_step(*_t(*args), DT, land=torch.from_numpy(cols["land"]))
    for name, a, b in zip(SPECIES + ("t", "precip"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("dt,cfg,n", [(200.0, {}, 2), (225.0, {}, 2), (150.0, {}, 1),
                                      (600.0, {"dt_split": 4}, 4), (600.0, {"mp_time": 0.5}, 600)])
def test_substep_count_is_pace_tpu_s(cols, dt, cfg, n, monkeypatch):
    """ceil(dt / mp_time) sub-steps (2 at bench.py's 200 s and the C12
    physics config's 225 s), or dt_split, counted by the fast adjustment's
    calls."""
    calls = []
    orig = tmp.fast_saturation_adjustment

    def counting(*a, **k):
        calls.append(a[8])
        return orig(*a, **k)

    monkeypatch.setattr(tmp, "fast_saturation_adjustment", counting)
    z = torch.zeros(1, 2, 1, 1, dtype=torch.float64)
    t = torch.full_like(z, 280.0)
    p = torch.full_like(z, 8e4)
    tmp.microphysics_step(z, z, z, z, z, z, t, p, torch.full_like(z, 1e3), dt,
                          tmp.MicrophysicsConfig(**cfg))
    assert len(calls) == n and calls[0] == dt / n


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

def _water(qs, delp):
    return float(sum(q * delp for q in qs).sum())


def _enthalpy(t, qv, qi, qs, qg, delp):
    return float(((CP * t + LV * qv - LF * (qi + qs + qg)) * delp).sum())


def test_fast_adjustment_and_cold_processes_conserve_water_and_enthalpy(cols):
    args = _t(*_args(cols, *SPECIES, "t", "p"))
    delp = torch.from_numpy(cols["delp"])
    q0, t0 = args[:6], args[6]
    for fn in (tmp.fast_saturation_adjustment, tmp.cold_processes):
        out = fn(*args, DT, tmp.MicrophysicsConfig())
        q1, t1 = out[:6], out[6]
        assert _water(q1, delp) == pytest.approx(_water(q0, delp), rel=1e-12)
        assert (_enthalpy(t1, q1[0], q1[2], q1[4], q1[5], delp)
                == pytest.approx(_enthalpy(t0, q0[0], q0[2], q0[4], q0[5], delp), rel=1e-12))
        assert sum(float((a - b).abs().max()) for a, b in zip(q1, q0)) > 0.0


def test_warm_rain_conserves_water_and_enthalpy(cols):
    qv, ql, qr, t, p = _t(*_args(cols, "qvapor", "qliquid", "qrain", "t", "p"))
    delp = torch.from_numpy(cols["delp"])
    qv1, ql1, qr1, t1 = tmp.warm_rain_processes(qv, ql, qr, t, p, DT, tmp.MicrophysicsConfig())
    assert _water((qv1, ql1, qr1), delp) == pytest.approx(_water((qv, ql, qr), delp), rel=1e-12)
    z = torch.zeros_like(qv)
    assert (_enthalpy(t1, qv1, z, z, z, delp)
            == pytest.approx(_enthalpy(t, qv, z, z, z, delp), rel=1e-12))


def test_step_conserves_water_with_precip_and_sediments(cols):
    """The column water lost is the surface precipitation; every species
    stays non-negative and the precipitation is positive where rain falls."""
    args = _t(*_args(cols, *SPECIES, "t", "p", "delp"))
    delp = args[-1]
    out = tmp.microphysics_step(*args, DT, tmp.MicrophysicsConfig())
    col0 = sum(q * delp for q in args[:6]).sum(dim=1) / constants.GRAV
    col1 = sum(q * delp for q in out[:6]).sum(dim=1) / constants.GRAV
    np.testing.assert_allclose((col1 + out[7]).numpy(), col0.numpy(), rtol=1e-12)
    assert float(out[7].min()) > 0.0
    for q in out[:6]:
        assert float(q.min()) >= 0.0


def test_sedimentation_alone_precipitates_and_conserves(cols):
    args = _t(*_args(cols, *SPECIES, "t", "p", "delp"))
    delp = args[-1]
    cfg = tmp.MicrophysicsConfig(do_warm_rain=False, do_ice=False)
    z = torch.zeros_like(args[0])
    out = tmp.microphysics_step(z, z, z, args[3], z, z, *args[6:], DT, cfg)
    col0 = (args[3] * delp).sum(dim=1) / constants.GRAV
    col1 = (out[3] * delp).sum(dim=1) / constants.GRAV
    np.testing.assert_allclose((col1 + out[7]).numpy(), col0.numpy(), rtol=1e-12)
    assert float(out[7].min()) > 0.0


def test_config_is_pace_tpu_s():
    assert ([(f.name, f.default) for f in dataclasses.fields(tmp.MicrophysicsConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jmp.MicrophysicsConfig)])
    assert jconstants.HLV == constants.HLV and jconstants.CP_AIR == constants.CP_AIR
