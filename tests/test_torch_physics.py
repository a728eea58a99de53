"""The port's physics entry point and its dycore coupling against pace_tpu's.

``dycore_to_physics``, ``update_atmosphere_state``,
``dry_convective_adjustment``, ``apply_wind_tendencies`` (with and without a
halo) and ``Physics`` of ``pace_tpu_torch.models.shield.physics`` against
their ``pace_tpu`` namesakes (XLA, CPU) on the same numpy inputs: the
baroclinic-wave state at C12 npz=8 with the tracer block of
``demos.physics_step.moist_tracers``, float64. ``Physics`` runs
``bench.py``'s schemes (GFDL microphysics and PBL), those of
``examples/configs/baroclinic_c12_physics.yaml`` (with shallow convection and
its surface fluxes), and deep convection with the dry adjustment; then one
nonhydrostatic ``step_dynamics`` of the dycore benchmark's flags (k_split=2,
n_split=2) followed by the yaml's ``Physics``, held on the compute domain as
``tests/test_torch_dycore.py`` holds the step. Tolerance: rtol 1e-12 with
atol 1e-12 of each field's scale. Then the configurations' fields and
defaults, each refusal, and the oracle properties of
``tests/main/test_physics.py`` on the port's side.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu import constants as jconstants
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.fv3 import dycore as jdycore
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.models.shield import microphysics as jmp
from pace_tpu.models.shield import pbl as jpbl
from pace_tpu.models.shield import physics as jphys
from pace_tpu.models.shield import sas as jsas
from pace_tpu.models.shield import surface as jsurface
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.models.shield import microphysics as tmp
from pace_tpu_torch.models.shield import pbl as tpbl
from pace_tpu_torch.models.shield import physics as tphys
from pace_tpu_torch.models.shield import sas as tsas
from pace_tpu_torch.models.shield import surface as tsurface

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


def test_step_then_physics_matches(setup):
    """One nonhydrostatic dycore step (the benchmark's flags, k_split=2,
    n_split=2) and the yaml's physics after it, on the compute domain."""
    cfg = ddemo.bench_config(NPZ, k_split=2, n_split=2, **ddemo.STABLE_DAMPING)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jcore = jdycore.DynamicalCore(setup["jgrid"], setup["jhalo"],
                                  jdycore.DynamicalCoreConfig(**kw), timestep=DT)
    tcore = dycore.DynamicalCore(setup["tgrid"], setup["thalo"], dycore.DynamicalCoreConfig(**kw),
                                 timestep=DT)
    jstate = dataclasses.replace(setup["jstate"], q_con=jnp.zeros_like(setup["jstate"].delp))
    want = _physics(jphys, jsas, setup["jgrid"], "c12 physics yaml")(
        jcore.step_dynamics(jstate))
    got = _physics(tphys, tsas, setup["tgrid"], "c12 physics yaml")(
        tcore.step_dynamics(setup["tstate"]))
    delp = _interior(jstate.delp)
    pe_max = float(setup["jgrid"].ptop + delp.sum(axis=1).max())
    dt = DT / 4
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    scales = {"w": p_err, "delz": p_err * dt}
    for name in ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pkz"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = a[..., H:a.shape[-2] - H, H:a.shape[-1] - H]
        b = b[..., H:b.shape[-2] - H, H:b.shape[-1] - H]
        _close(a, b, name, scale=max(np.abs(b).max(), scales.get(name, 0.0)))


# ----------------------------------------------------------------------
# configurations and refusals
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cls,jmod,tmod", [
    ("MicrophysicsConfig", jmp, tmp), ("PBLConfig", jpbl, tpbl),
    ("ShallowConvectionConfig", jsas, tsas), ("DeepConvectionConfig", jsas, tsas),
    ("SurfaceConfig", jsurface, tsurface),
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


@pytest.mark.parametrize("scheme", tphys.UNPORTED_SCHEMES)
def test_unported_scheme_is_refused(setup, scheme):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        tphys.Physics(setup["tgrid"], ("GFS_microphysics", scheme), DT)


@pytest.mark.parametrize("kind", ["land", "seaice", "mixed"])
def test_interactive_surface_is_refused(setup, kind):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        tphys.Physics(setup["tgrid"], ("GFS_PBL",), DT,
                      surface_config=tsurface.SurfaceConfig(type=kind))


def test_checkpointer_is_refused(setup):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        tphys.Physics(setup["tgrid"], ("GFS_microphysics",), DT,
                      checkpointer=lambda *a, **k: None)


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
