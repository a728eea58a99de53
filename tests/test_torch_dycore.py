"""One whole dycore step of the port against pace_tpu's, and the dycore's
configuration.

``DynamicalCore.step_dynamics`` of ``pace_tpu_torch`` against ``pace_tpu``'s
(XLA path) with the dycore benchmark's flags at ``k_split=2, n_split=2``
(``demos.dycore_step.bench_config``), from the Jablonowski-Williamson state
with a seeded tracer block that has negative values (so ``fill`` acts), C12
npz=8, float64. One reference step is shared by the file. Tolerance on the
compute domain (fluxes on the interfaces that bound it): rtol 1e-12 with
atol 1e-12 of each field's scale, its largest reference value except where
a difference of pressures near 1e5 Pa sets it: ``w`` 1e-12 of the largest
interface pressure times ``dt / dm`` of the lightest layer (acoustic ``dt``),
``delz`` that times ``dt``, ``omga`` the largest interface pressure over the
outer step. Then the configuration's fields, defaults and refusals, and the
step's indifference to the pressure gradient's ghost columns.
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
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import acoustics, dycore
from pace_tpu_torch.models.fv3.state import DycoreState

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
K_SPLIT, N_SPLIT = 2, 2
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd", "q_con")


def _kw():
    cfg = ddemo.bench_config(NPZ, k_split=K_SPLIT, n_split=N_SPLIT)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def steps():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    q = 1e-3 * rng.random(jstate.q.shape) - 5e-5
    jstate = dataclasses.replace(jstate, q=jnp.asarray(q), q_con=jnp.zeros_like(jstate.delp))
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    thalo = MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo
    jcore = jdycore.DynamicalCore(jgrid, mt.halo, jdycore.DynamicalCoreConfig(**_kw()),
                                  timestep=ddemo.TIMESTEP)
    tcore = dycore.DynamicalCore(tgrid, thalo, dycore.DynamicalCoreConfig(**_kw()),
                                 timestep=ddemo.TIMESTEP)
    delp = sarrays["delp"][..., H:-H, H:-H]
    pe_max = float(jgrid.ptop + delp.sum(axis=1).max())
    dt = ddemo.TIMESTEP / (K_SPLIT * N_SPLIT)
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    return dict(
        want=jcore.step_dynamics(jstate), got=tcore.step_dynamics(tstate), tcore=tcore,
        tstate=tstate, tgrid=tgrid,
        scales={"w": p_err, "delz": p_err * dt, "omga": pe_max * K_SPLIT / ddemo.TIMESTEP},
    )


def _region(shape):
    dy, dx = shape[-2] - (N + 2 * H), shape[-1] - (N + 2 * H)
    return np.s_[..., H:H + N + dy, H:H + N + dx]


@pytest.mark.parametrize("name", FIELDS)
def test_step_matches(steps, name):
    want = np.asarray(getattr(steps["want"], name))
    got = getattr(steps["got"], name).numpy()
    assert got.shape == want.shape
    region = _region(want.shape)
    got, want = got[region], want[region]
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), steps["scales"].get(name, 0.0))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def test_step_conserves_dry_and_tracer_mass(steps):
    """sum(delp area) and the total tracer mass over the compute domain
    (fill moves tracer mass between species and levels, never out)."""
    before, after, grid = steps["tstate"], steps["got"], steps["tgrid"]
    i = (..., slice(H, -H), slice(H, -H))
    area = grid.area[i][:, None]

    def masses(st):
        dm = st.delp[i] * area
        return float(dm.sum()), float((st.q[i] * dm[:, None]).sum())

    (m0, q0), (m1, q1) = masses(before), masses(after)
    assert abs(m1 - m0) <= 1e-12 * m0
    assert abs(q1 - q0) <= 1e-12 * q0
    assert float(after.q[i].min()) >= 0.0  # the negative tracers were filled


def test_step_records_tracer_subcycles(steps):
    assert steps["tcore"].tracer_subcycles == [1] * K_SPLIT


def test_step_ignores_the_pressure_gradient_s_ghost_columns(steps, monkeypatch):
    """Every ghost column of the D-grid pressure gradient's u and v is
    overwritten before it is read, so the kernel may leave them as it likes."""
    orig = acoustics.nh_p_grad_best

    def poisoned(*a, **k):
        u, v = (t.clone() for t in orig(*a, **k))
        for t in (u, v):
            keep = t[..., H:t.shape[-2] - H, H:t.shape[-1] - H].clone()
            t.fill_(float("nan"))
            t[..., H:t.shape[-2] - H, H:t.shape[-1] - H] = keep
        return u, v

    monkeypatch.setattr(acoustics, "nh_p_grad_best", poisoned)
    got = steps["tcore"].step_dynamics(steps["tstate"])
    for name in ("u", "v", "w", "delp", "pt", "q", "ua", "vc"):
        a, b = getattr(got, name), getattr(steps["got"], name)
        region = _region(tuple(a.shape))
        assert torch.equal(a[region], b[region]), name


def test_config_fields_and_defaults_are_pace_tpu_s():
    jf = dataclasses.fields(jdycore.DynamicalCoreConfig)
    tf = dataclasses.fields(dycore.DynamicalCoreConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    assert (dataclasses.asdict(dycore.DynamicalCoreConfig())
            == dataclasses.asdict(jdycore.DynamicalCoreConfig()))


def test_acoustic_view_is_pace_tpu_s():
    want = jdycore.DynamicalCoreConfig(**_kw()).acoustic()
    got = dycore.DynamicalCoreConfig(**_kw()).acoustic()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", [dict(ke_bg=0.1), dict(z_tracer=False)])
def test_config_refuses_what_pace_tpu_refuses(bad):
    with pytest.raises(ValueError):
        jdycore.DynamicalCoreConfig(**bad)
    with pytest.raises(ValueError):
        dycore.DynamicalCoreConfig(**bad)


@pytest.mark.parametrize("what", ["do_sat_adj", "checkpointer"])
def test_unported_options_raise(steps, what):
    """A stage checkpointer (ROADMAP queue 1 item 6) raises. do_sat_adj,
    refused until the saturation adjustment was ported, now builds the
    dycore with its saturation-adjustment configuration (the step itself is
    held against pace_tpu's in test_torch_sat_adjust.py)."""
    if what == "do_sat_adj":
        core = dycore.DynamicalCore(steps["tgrid"], None,
                                    dycore.DynamicalCoreConfig(do_sat_adj=True), 200.0)
        assert core._sat_adjust_config == core.config.sat_adjust_config()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        dycore.DynamicalCore(steps["tgrid"], None, dycore.DynamicalCoreConfig(), 200.0,
                             checkpointer=lambda *a, **k: None)


def test_bench_config_is_bench_py_s():
    cfg = ddemo.bench_config()
    want = dict(npz=79, k_split=7, n_split=8, hydrostatic=False, nord=3, d4_bg=0.15, d2_bg=0.0,
                d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5, do_vort_damp=True, vtdm4=0.06,
                d_con=1.0, rf_cutoff=3000.0, rf_fast=True, tau=10.0, fill=True, n_sponge=48,
                hord_mt=6, hord_vt=6, hord_tm=6, hord_dp=6, hord_tr=8, kord_mt=9, kord_tm=-9,
                kord_tr=9, kord_wz=9, tracer_dynamic_subcycle=True)
    assert {k: getattr(cfg, k) for k in want} == want
    assert ddemo.TIMESTEP == 200.0


def test_demo_run_reports_the_metric():
    out = ddemo.run(12, 8, warm=0, steps=1, device="cpu", dtype=torch.float64,
                    k_split=1, n_split=2)
    assert len(out["step_ms"]) == 1 and out["tracer_subcycles"] == [[1]]
    assert out["gridpoints_per_s"] == pytest.approx(6 * 12 * 12 * 8 / (out["ms_per_step"] / 1e3))
    st = out["case"].state
    assert bool(torch.isfinite(st.u).all())


def test_bench_top_damping_diverges_and_without_the_del2_boost_does_not():
    """From the baroclinic-wave state bench.py's del-2 boost of the top two
    levels (d2_bg_k1, d2_bg_k2), added to the del-8 damping there, grows a
    grid-scale mode at the model top by a factor of about 1.6 per substep
    after some 25 substeps, until the first step fails on a NaN Courant
    number. Four of the seven outer steps at bench.py's substep length show
    it, in pace_tpu's step as in the port's; without the boost the winds of
    both stay at the state's 35 m/s."""
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    top = {}
    for name, over in (("bench", {}), ("boost off", dict(d2_bg_k1=0.0, d2_bg_k2=0.0))):
        cfg = ddemo.bench_config(NPZ, k_split=4, **over)
        case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
        core = dycore.DynamicalCore(case.grid, case.halo, cfg, timestep=ddemo.TIMESTEP * 4 / 7)
        got = core.step_dynamics(case.state).u[..., H:-H, H:-H].abs().max()
        jcfg = jdycore.DynamicalCoreConfig(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        jcore = jdycore.DynamicalCore(jgrid, mt.halo, jcfg, timestep=ddemo.TIMESTEP * 4 / 7)
        want = np.abs(np.asarray(jcore.step_dynamics(jstate).u)[..., H:-H, H:-H]).max()
        # a NaN counts as past every bound
        top[name] = {"port": np.nan_to_num(float(got), nan=np.inf),
                     "pace_tpu": np.nan_to_num(float(want), nan=np.inf)}
    for impl in ("port", "pace_tpu"):
        assert top["bench"][impl] > 100.0, (impl, top)
        assert top["boost off"][impl] < 40.0, (impl, top)
