"""The port's physics entry point and its dycore coupling against pace_tpu's.

``dycore_to_physics``, ``update_atmosphere_state``,
``dry_convective_adjustment``, ``apply_wind_tendencies`` (with and without a
halo) and ``Physics`` of ``pace_tpu_torch.models.shield.physics`` against
their ``pace_tpu`` namesakes (XLA, CPU) on the same numpy inputs: the
baroclinic-wave state at C12 npz=8 with the tracer block of
``demos.physics_step.moist_tracers``, float64. ``Physics`` runs
``bench.py``'s schemes (GFDL microphysics and PBL), those of
``examples/configs/baroclinic_c12_physics.yaml`` (with shallow convection and
its surface fluxes), and deep convection with the dry adjustment; then the
physics of each example config with a physics section (earthlike,
aquaplanet, terraplanet, gray_aquaplanet, held_suarez), built from its yaml
as ``pace_tpu``'s driver builds it, and band radiation over land, the RJ
simple physics and the aquaplanet with the diurnal and seasonal insolation,
each over two calls so that the surface state and the precipitation carry
(held with the state). Then one nonhydrostatic ``step_dynamics`` of the
dycore benchmark's flags (k_split=2, n_split=2) followed by the c12 yaml's
and by earthlike's ``Physics``, held on the compute domain as
``tests/test_torch_dycore.py`` holds the step. Tolerance: rtol 1e-12 with
atol 1e-12 of each field's scale. Then the configurations' fields and
defaults, the stages a checkpointer sees, and the oracle properties of
``tests/main/test_physics.py`` on the port's side.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu import constants as jconstants
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.fv3 import dycore as jdycore
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.models.shield import band_radiation as jband
from pace_tpu.models.shield import held_suarez as jhs
from pace_tpu.models.shield import lsm as jlsm
from pace_tpu.models.shield import microphysics as jmp
from pace_tpu.models.shield import pbl as jpbl
from pace_tpu.models.shield import physics as jphys
from pace_tpu.models.shield import radiation as jrad
from pace_tpu.models.shield import sas as jsas
from pace_tpu.models.shield import seaice as jice
from pace_tpu.models.shield import simple_physics as jrj
from pace_tpu.models.shield import surface as jsurface
from pace_tpu.utils import registry as jreg
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.models.shield import band_radiation as tband
from pace_tpu_torch.models.shield import held_suarez as ths
from pace_tpu_torch.models.shield import lsm as tlsm
from pace_tpu_torch.models.shield import microphysics as tmp
from pace_tpu_torch.models.shield import pbl as tpbl
from pace_tpu_torch.models.shield import physics as tphys
from pace_tpu_torch.models.shield import radiation as trad
from pace_tpu_torch.models.shield import sas as tsas
from pace_tpu_torch.models.shield import seaice as tice
from pace_tpu_torch.models.shield import simple_physics as trj
from pace_tpu_torch.models.shield import surface as tsurface
from pace_tpu_torch.utils import registry as treg

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
DT = ddemo.TIMESTEP
#: examples/configs/baroclinic_c12_physics.yaml's schemes and shallow fluxes
YAML_SCHEMES = ("GFS_microphysics", "GFS_PBL", "GFS_shallow_convection")
YAML_FLUXES = dict(sensible_heat_flux=0.02, latent_heat_flux=2.0e-5)
STATE_FIELDS = ("u", "v", "pt", "q", "delp")


@pytest.fixture(scope="module")
def setup():
    """pace_tpu's and the port's grid, halo and moist state, from the same
    numpy arrays."""
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    q = pdemo.moist_tracers(tstate, seed=0)
    tstate.q = torch.from_numpy(q.copy())
    jstate = dataclasses.replace(jstate, q=jnp.asarray(q))
    return dict(
        jgrid=jgrid, jhalo=mt.halo, jstate=jstate,
        tgrid=GridData.from_numpy(garrays, device="cpu", dtype=torch.float64),
        thalo=MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo,
        tstate=tstate,
    )


def _close(got, want, name="", scale=None):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def _interior(a):
    return np.asarray(a)[..., H:-H, H:-H]


def test_dycore_to_physics_and_back_match(setup):
    jphy = jphys.dycore_to_physics(setup["jstate"])
    tphy = tphys.dycore_to_physics(setup["tstate"])
    for f in dataclasses.fields(tphys.PhysicsState):
        a, b = getattr(tphy, f.name), getattr(jphy, f.name)
        if b is None:
            assert a is None
            continue
        _close(a, b, f.name)
    # an update of every field goes back into a new state
    rng = np.random.default_rng(1)
    new = {f: rng.uniform(0.5, 1.5) * np.asarray(getattr(jphy, f)) for f in
           ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel", "pt")}
    q_in = setup["tstate"].q.clone()
    got = tphys.update_atmosphere_state(setup["tstate"], dataclasses.replace(
        tphy, **{k: torch.from_numpy(v) for k, v in new.items()}))
    want = jphys.update_atmosphere_state(setup["jstate"], dataclasses.replace(
        jphy, **{k: jnp.asarray(v) for k, v in new.items()}))
    _close(got.q, want.q, "q")
    _close(got.pt, want.pt, "pt")
    assert torch.equal(setup["tstate"].q, q_in)  # the input state is not written


def test_tendency_state_zeros(setup):
    z = tphys.TendencyState.init_zeros(setup["tstate"].pt)
    assert [f.name for f in dataclasses.fields(z)] == ["u_dt", "v_dt", "pt_dt"]
    assert all(float(getattr(z, f).abs().max()) == 0.0 for f in ("u_dt", "v_dt", "pt_dt"))


@pytest.mark.parametrize("tracers", ["block", "one field"])
def test_dry_convective_adjustment_matches(setup, tracers):
    rng = np.random.default_rng(2)
    pt = np.asarray(setup["jstate"].pt)
    pt = pt * rng.uniform(0.97, 1.03, pt.shape)  # statically unstable pairs
    q = np.asarray(setup["jstate"].q)
    if tracers == "one field":
        q = q[:, 0]
    delp = np.asarray(setup["jstate"].delp)
    want = jphys.dry_convective_adjustment(jnp.asarray(pt), jnp.asarray(q), jnp.asarray(delp),
                                           DT, 600.0)
    args = [torch.from_numpy(np.array(a)) for a in (pt, q, delp)]
    before = [a.clone() for a in args]
    got = tphys.dry_convective_adjustment(*args, DT, 600.0)
    for name, a, b in zip(("pt", "q"), got, want):
        _close(a, b, name)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    assert float((got[0] - args[0]).abs().max()) > 0.0


@pytest.mark.parametrize("with_halo", [False, True])
def test_apply_wind_tendencies_matches(setup, with_halo):
    rng = np.random.default_rng(3)
    shape = np.asarray(setup["jstate"].pt).shape
    u_dt, v_dt = rng.standard_normal(shape) * 1e-3, rng.standard_normal(shape) * 1e-3
    u_dt[..., 0, 0] = np.nan  # ghost columns are undefined
    js, ts = setup["jstate"], setup["tstate"]
    want = jphys.apply_wind_tendencies(js.u, js.v, jnp.asarray(u_dt), jnp.asarray(v_dt),
                                       setup["jgrid"], DT,
                                       halo=setup["jhalo"] if with_halo else None)
    got = tphys.apply_wind_tendencies(ts.u, ts.v, torch.from_numpy(u_dt),
                                      torch.from_numpy(v_dt), setup["tgrid"], DT,
                                      halo=setup["thalo"] if with_halo else None)
    for name, a, b in zip(("u", "v"), got, want):
        # the D-grid points of the compute domain and its bounding interfaces
        a = a[..., H:a.shape[-2] - H, H:a.shape[-1] - H]
        b = np.asarray(b)[..., H:b.shape[-2] - H, H:b.shape[-1] - H]
        _close(a, b, name)


PHYSICS_CASES = {
    "bench": dict(schemes=("GFS_microphysics", "GFS_PBL")),
    "c12 physics yaml": dict(schemes=YAML_SCHEMES, sas=YAML_FLUXES),
    "deep, sg_adj": dict(schemes=("GFS_deep_convection", "GFS_microphysics"),
                         deep=YAML_FLUXES, fv_sg_adj=600.0),
}


def _physics(mod, cfgs, grid, case):
    c = PHYSICS_CASES[case]
    kw = dict(fv_sg_adj=c.get("fv_sg_adj", 0.0))
    if "sas" in c:
        kw["sas_config"] = cfgs.ShallowConvectionConfig(**c["sas"])
    if "deep" in c:
        kw["deep_config"] = cfgs.DeepConvectionConfig(**c["deep"])
    return mod.Physics(grid, c["schemes"], DT, **kw)


@pytest.mark.parametrize("case", sorted(PHYSICS_CASES))
def test_physics_call_matches(setup, case):
    want = _physics(jphys, jsas, setup["jgrid"], case)(setup["jstate"])
    before = {f: getattr(setup["tstate"], f).clone() for f in STATE_FIELDS}
    got = _physics(tphys, tsas, setup["tgrid"], case)(setup["tstate"])
    for f in STATE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        _close(a[..., H:a.shape[-2] - H, H:a.shape[-1] - H],
               np.asarray(b)[..., H:b.shape[-2] - H, H:b.shape[-1] - H], f)
        assert torch.equal(getattr(setup["tstate"], f), before[f]), f  # input not written
    # the oracle of tests/main/test_physics.py: no negative water, bounded
    # temperature change
    assert float(got.q[..., H:-H, H:-H].min()) > -1e-12
    assert float((got.pt - setup["tstate"].pt)[..., H:-H, H:-H].abs().max()) < 50.0


@pytest.fixture(scope="module")
def stepped(setup):
    """One nonhydrostatic dycore step (the benchmark's flags, k_split=2,
    n_split=2) in pace_tpu and in the port, from the moist state."""
    cfg = ddemo.bench_config(NPZ, k_split=2, n_split=2, **ddemo.STABLE_DAMPING)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jcore = jdycore.DynamicalCore(setup["jgrid"], setup["jhalo"],
                                  jdycore.DynamicalCoreConfig(**kw), timestep=DT)
    tcore = dycore.DynamicalCore(setup["tgrid"], setup["thalo"], dycore.DynamicalCoreConfig(**kw),
                                 timestep=DT)
    jstate = dataclasses.replace(setup["jstate"], q_con=jnp.zeros_like(setup["jstate"].delp))
    delp = _interior(jstate.delp)
    pe_max = float(setup["jgrid"].ptop + delp.sum(axis=1).max())
    dt = DT / 4
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    return dict(jstate=jcore.step_dynamics(jstate), tstate=tcore.step_dynamics(setup["tstate"]),
                scales={"w": p_err, "delz": p_err * dt})


def _close_step(got, want, scales):
    """The state after a step and a physics call, on the compute domain."""
    for name in ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pkz"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = a[..., H:a.shape[-2] - H, H:a.shape[-1] - H]
        b = b[..., H:b.shape[-2] - H, H:b.shape[-1] - H]
        _close(a, b, name, scale=max(np.abs(b).max(), scales.get(name, 0.0)))


def test_step_then_physics_matches(setup, stepped):
    """The dycore step and the physics of baroclinic_c12_physics.yaml after
    it, on the compute domain."""
    want = _physics(jphys, jsas, setup["jgrid"], "c12 physics yaml")(stepped["jstate"])
    got = _physics(tphys, tsas, setup["tgrid"], "c12 physics yaml")(stepped["tstate"])
    _close_step(got, want, stepped["scales"])


def test_step_then_earthlike_physics_matches(setup, stepped):
    """The dycore step and earthlike_c24.yaml's physics after it (over the
    step's timestep), with the surface state it leaves."""
    jp = _example_physics(J, "earthlike", setup["jgrid"], dt=DT)
    tp = _example_physics(T, "earthlike", setup["tgrid"], dt=DT)
    _close_step(tp(stepped["tstate"]), jp(stepped["jstate"]), stepped["scales"])
    _close_surface(tp.surface_state, jp.surface_state, "earthlike")


# ----------------------------------------------------------------------
# the example configs' physics, each over two calls
# ----------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the sat-adjustment keys that pace_tpu's driver takes from dycore_config
#: into the microphysics config (pace_tpu/driver/driver.py)
SHARED_MP_KEYS = ("tau_l2v", "tau_v2l", "tau_i2s", "tau_g2v", "ql_gen", "ql_mlt", "qs_mlt",
                  "qi_lim", "dw_ocean", "dw_land", "icloud_f", "do_qa")
J = SimpleNamespace(from_dict=jreg.from_dict, Physics=jphys.Physics,
                    dycore=jdycore.DynamicalCoreConfig,
                    mp=jmp.MicrophysicsConfig, pbl=jpbl.PBLConfig, rad=jrad.GrayRadiationConfig,
                    sas=jsas.ShallowConvectionConfig, deep=jsas.DeepConvectionConfig,
                    surface=jsurface.SurfaceConfig, hs=jhs.HeldSuarezConfig,
                    band=jband.BandRadiationConfig)
T = SimpleNamespace(from_dict=treg.from_dict, Physics=tphys.Physics,
                    dycore=dycore.DynamicalCoreConfig,
                    mp=tmp.MicrophysicsConfig, pbl=tpbl.PBLConfig, rad=trad.GrayRadiationConfig,
                    sas=tsas.ShallowConvectionConfig, deep=tsas.DeepConvectionConfig,
                    surface=tsurface.SurfaceConfig, hs=ths.HeldSuarezConfig,
                    band=tband.BandRadiationConfig)
#: cases beyond the example configs: (yaml whose physics is changed, the
#: changes of its physics_config, the two calls' model times)
EXTRA_CASES = {
    "band_radiation, land": ("terraplanet", dict(
        schemes=["band_radiation", "GFS_PBL", "GFS_microphysics"]), (0.0, 450.0)),
    "RJ_simple_physics": ("held_suarez", dict(schemes=["RJ_simple_physics"]), (0.0, 600.0)),
    "aquaplanet, diurnal and seasonal": ("aquaplanet", dict(radiation=dict(
        interactive_vapor=True, diurnal=True, seasonal=True)), (1.5e7 + 123.4, 1.5e7 + 573.4)),
}
EXAMPLES = ("earthlike", "aquaplanet", "terraplanet", "gray_aquaplanet", "held_suarez")


def _example_physics(m, name, grid, dt=None, **changes):
    """``Physics`` of examples/configs/{name}_c24.yaml's physics_config
    (with ``changes``), its fv_sg_adj and dt_atmos (or ``dt``), built as
    pace_tpu's driver builds it, from ``m``'s package."""
    with open(os.path.join(ROOT, "examples", "configs", f"{name}_c24.yaml")) as f:
        doc = yaml.safe_load(f)
    pc, dc = {**doc["physics_config"], **changes}, doc["dycore_config"]
    shared = {k: dc.get(k, getattr(m.dycore(), k)) for k in SHARED_MP_KEYS}

    def load(cls, key):
        return m.from_dict(cls, pc.get(key) or {})

    return m.Physics(
        grid, tuple(pc["schemes"]), dt or doc["dt_atmos"], fv_sg_adj=dc.get("fv_sg_adj", 0.0),
        config=m.from_dict(m.mp, {**shared, **(pc.get("microphysics") or {})}),
        pbl_config=load(m.pbl, "pbl"), radiation_config=load(m.rad, "radiation"),
        sas_config=load(m.sas, "shallow_convection"), deep_config=load(m.deep, "deep_convection"),
        surface_config=load(m.surface, "surface"), held_suarez_config=load(m.hs, "held_suarez"),
        band_radiation_config=load(m.band, "band_radiation"))


def _surface_fields(sfc):
    out = {"precip": sfc.precip}
    for part in ("lsm", "ice"):
        sub = getattr(sfc, part)
        if sub is not None:
            out.update({f"{part}.{f.name}": getattr(sub, f.name) for f in dataclasses.fields(sub)})
    return out


def _close_surface(got, want, label):
    assert (got is None) == (want is None), label
    if got is None:
        return
    w = _surface_fields(want)
    g = _surface_fields(got)
    assert sorted(g) == sorted(w), label
    for k in w:
        _close(g[k][..., H:-H, H:-H], _interior(w[k]), f"{label} surface {k}")


@pytest.mark.parametrize("case", EXAMPLES + tuple(EXTRA_CASES))
def test_example_physics_matches_over_two_calls(setup, case):
    name, changes, times = EXTRA_CASES.get(case, (case, {}, None))
    jp = _example_physics(J, name, setup["jgrid"], **changes)
    tp = _example_physics(T, name, setup["tgrid"], **changes)
    times = times or (0.0, tp.timestep)
    js, ts = setup["jstate"], setup["tstate"]
    for call, t in enumerate(times):
        ts_in, sfc_in = ts, tp.surface_state
        before = {f: getattr(ts_in, f).clone() for f in STATE_FIELDS}
        sfc_before = {k: v.clone() for k, v in _surface_fields(sfc_in).items()} if sfc_in else {}
        js, ts = jp(js, t), tp(ts, t)
        label = f"{case} call {call}"
        for f in STATE_FIELDS:
            _close(getattr(ts, f)[..., H:-H, H:-H], _interior(getattr(js, f)), f"{label} {f}")
        _close_surface(tp.surface_state, jp.surface_state, label)
        # neither the state nor the surface state a call is given is written
        for f in STATE_FIELDS:
            assert torch.equal(getattr(ts_in, f), before[f]), f"{label} {f} written"
        for k, v in sfc_before.items():
            assert torch.equal(_surface_fields(sfc_in)[k], v), f"{label} surface {k} written"
        assert float(ts.q[..., H:-H, H:-H].min()) > -1e-12
    if tp.surface_state is not None:
        assert float(tp.surface_state.precip[..., H:-H, H:-H].max()) > 0.0  # carried


# ----------------------------------------------------------------------
# configurations and the stages a checkpointer sees
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cls,jmod,tmod", [
    ("MicrophysicsConfig", jmp, tmp), ("PBLConfig", jpbl, tpbl),
    ("ShallowConvectionConfig", jsas, tsas), ("DeepConvectionConfig", jsas, tsas),
    ("SurfaceConfig", jsurface, tsurface), ("GrayRadiationConfig", jrad, trad),
    ("BandRadiationConfig", jband, tband), ("HeldSuarezConfig", jhs, ths),
    ("SimplePhysicsConfig", jrj, trj), ("LSMConfig", jlsm, tlsm), ("SeaIceConfig", jice, tice),
])
def test_config_fields_and_defaults_are_pace_tpu_s(cls, jmod, tmod):
    """The physics has no weights: its parameters are these fields."""
    jf, tf = dataclasses.fields(getattr(jmod, cls)), dataclasses.fields(getattr(tmod, cls))
    assert [(f.name, f.type, f.default) for f in tf] == [(f.name, f.type, f.default) for f in jf]


def test_registry_and_sat_adjust_config_are_pace_tpu_s():
    assert tphys.PHYSICS_PACKAGES == jphys.PHYSICS_PACKAGES
    kw = dict(tau_v2l=90.0, dw_land=0.15, do_qa=True, icloud_f=1)
    assert (dataclasses.asdict(dycore.DynamicalCoreConfig(**kw).sat_adjust_config())
            == dataclasses.asdict(jdycore.DynamicalCoreConfig(**kw).sat_adjust_config()))


def test_checkpointer_is_refused(setup):
    """Refused until the stage hooks were ported: a checkpointer is now
    kept and sees Physics-In and Physics-Out (held against pace_tpu's in
    test_torch_checkpointer.py)."""
    seen = []
    phys = tphys.Physics(setup["tgrid"], ("held_suarez",), DT,
                         checkpointer=lambda stage, **v: seen.append((stage, sorted(v))))
    phys(setup["tstate"])
    assert seen == [(s, ["delp", "pt", "q", "u", "v"]) for s in ("Physics-In", "Physics-Out")]


def test_unknown_scheme_is_an_error(setup):
    with pytest.raises(ValueError):
        jphys.Physics(setup["jgrid"], ("GFS_radiation",), DT)
    with pytest.raises(ValueError):
        tphys.Physics(setup["tgrid"], ("GFS_radiation",), DT)


def test_demo_seeds_and_runs(setup):
    """The demo's tracer block: vapor within [0.3, 1.1] of saturation at the
    dry temperature (capped), condensates within their bounds; one step with
    physics on the CPU reports both wall times."""
    st = setup["tstate"]
    q = pdemo.moist_tracers(st, seed=0)
    np.testing.assert_array_equal(q, pdemo.moist_tracers(st, seed=0))
    pe = st.pe
    qsat = np.minimum(pdemo.QSAT_MAX, tmp.saturation_mixing_ratio(
        st.pt * st.pkz, 0.5 * (pe[:, 1:] + pe[:, :-1])).numpy())
    ratio = q[:, TRACER_NAMES.index("qvapor")] / qsat
    assert 0.3 <= ratio.min() and ratio.max() <= 1.1
    for name, top in pdemo.CONDENSATE_MAX.items():
        assert 0.0 <= q[:, TRACER_NAMES.index(name)].min() and \
            q[:, TRACER_NAMES.index(name)].max() <= top
    out = pdemo.run(N, 4, warm=0, steps=1, device="cpu", dtype=torch.float64, k_split=1,
                    n_split=1)
    assert out["physics_ms_per_step"] < out["ms_per_step"]
    assert out["case"].physics.schemes == pdemo.SCHEMES
    assert bool(torch.isfinite(out["case"].state.q[..., H:-H, H:-H]).all())


def test_demo_runs_earthlike_with_its_surface():
    """The demo's earthlike set on the CPU: two steps advance the model time
    by two timesteps, and the surface state carries across them."""
    out = pdemo.run(N, 4, warm=0, steps=2, device="cpu", dtype=torch.float64, k_split=1,
                    n_split=1, **pdemo.EARTHLIKE)
    case = out["case"]
    assert case.physics.schemes == pdemo.EARTHLIKE["schemes"]
    assert case.time_seconds == 2 * ddemo.TIMESTEP
    sfc = case.physics.surface_state
    tskin = case.physics._surface.tskin(sfc)[..., H:-H, H:-H]
    assert bool(torch.isfinite(tskin).all()) and 200.0 < float(tskin.min())
    assert float(tskin.max()) < 340.0 and float(sfc.precip[..., H:-H, H:-H].max()) > 0.0
    assert bool(torch.isfinite(case.state.q[..., H:-H, H:-H]).all())
