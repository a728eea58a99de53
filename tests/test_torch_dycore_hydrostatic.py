"""One whole hydrostatic dycore step of the port against pace_tpu's.

``DynamicalCore.step_dynamics`` of ``pace_tpu_torch`` against ``pace_tpu``'s
(XLA path) with the flag set of ``examples/configs/baroclinic_c12.yaml``
(hydrostatic, ``nord = 1``, ``k_split = 1``, ``n_split = 5``, ``d4_bg =
0.15``, hord 6 with tracers at 8, its ``dt_atmos``; every other field at its
default: no Rayleigh damping, no ``fill``, dynamic tracer sub-cycling), from
the Jablonowski-Williamson state with the perturbation on and a seeded
positive tracer block, C12 npz=8, float64. This runs the hydrostatic
acoustic loop (``one_grad_p``), d_sw's two-field transport (pt and
vorticity), the remap's hydrostatic ``pkz`` branch and ``nord = 1``. Held on
the compute domain (fluxes on the interfaces that bound it) within rtol
1e-12 and 1e-12 of each field's largest reference value.

A second step from the same state adds the two paths that file does not
set: slow Rayleigh damping (``tau > 0`` with ``rf_fast`` off: ``ray_fast``
once per outer step after the remap, with the file family's ``tau = 10``
and ``rf_cutoff = 3000`` Pa, which reach the top three levels at npz=8) and
``tracer_dynamic_subcycle = False`` (``n_split_tracer`` sub-cycles), held
the same way.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.fv3 import dycore as jdycore
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.ops import d_sw

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
CONFIG = os.path.join(os.path.dirname(__file__), "..", "examples", "configs",
                      "baroclinic_c12.yaml")
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd", "q_con")


def _yaml():
    with open(CONFIG) as f:
        return yaml.safe_load(f)


def _kw():
    return dict(_yaml()["dycore_config"], npz=NPZ)


#: the two flags of the second step
RAYLEIGH = dict(tau=10.0, rf_cutoff=3000.0, rf_fast=False, tracer_dynamic_subcycle=False)


def _step(**extra):
    """One step of each implementation from the same state, with the
    file's flag set and ``extra``."""
    timestep = float(_yaml()["dt_atmos"])
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    q = 1e-3 * rng.random(jstate.q.shape) + 1e-4
    jstate = dataclasses.replace(jstate, q=jnp.asarray(q))
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    thalo = MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo
    jcore = jdycore.DynamicalCore(jgrid, mt.halo,
                                  jdycore.DynamicalCoreConfig(**_kw(), **extra),
                                  timestep=timestep)
    tcore = dycore.DynamicalCore(tgrid, thalo, dycore.DynamicalCoreConfig(**_kw(), **extra),
                                 timestep=timestep)
    multi_calls = []
    orig = d_sw.fvtp2d_multi_best

    def counting(fields, *a, **k):
        multi_calls.append(len(fields))
        return orig(fields, *a, **k)

    d_sw.fvtp2d_multi_best = counting
    try:
        got = tcore.step_dynamics(tstate)
    finally:
        d_sw.fvtp2d_multi_best = orig
    return dict(want=jcore.step_dynamics(jstate), got=got, tcore=tcore, tstate=tstate,
                tgrid=tgrid, multi_calls=multi_calls)


@pytest.fixture(scope="module")
def steps():
    return _step()


@pytest.fixture(scope="module")
def steps_rayleigh():
    return _step(**RAYLEIGH)


def _region(shape):
    dy, dx = shape[-2] - (N + 2 * H), shape[-1] - (N + 2 * H)
    return np.s_[..., H:H + N + dy, H:H + N + dx]


def test_config_is_the_example_file_s():
    cfg = dycore.DynamicalCoreConfig(**_kw())
    assert cfg.hydrostatic and cfg.nord == 1 and (cfg.k_split, cfg.n_split) == (1, 5)
    assert not cfg.rf_fast and not cfg.fill and cfg.tau == 0.0


def test_chip_smoke_runs_the_example_file_s_flag_set():
    """chip_smoke.py's hydrostatic step (whose machine may lack a YAML
    parser) keeps its own copy of the file's flag set and time step."""
    import chip_smoke

    assert chip_smoke.HYDROSTATIC_STEP_CONFIG == _yaml()["dycore_config"]
    assert chip_smoke.HYDROSTATIC_STEP_DT == float(_yaml()["dt_atmos"])


def _matches(steps, name):
    want_v, got_v = getattr(steps["want"], name), getattr(steps["got"], name)
    assert (want_v is None) == (got_v is None), name
    if want_v is None:
        return
    want = np.asarray(want_v)
    got = got_v.numpy()
    assert got.shape == want.shape
    region = _region(want.shape)
    got, want = got[region], want[region]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("name", FIELDS)
def test_hydrostatic_step_matches(steps, name):
    _matches(steps, name)


@pytest.mark.parametrize("name", FIELDS)
def test_hydrostatic_step_with_slow_rayleigh_damping_and_fixed_subcycles_matches(
        steps_rayleigh, name):
    _matches(steps_rayleigh, name)


def test_slow_rayleigh_damping_acts(steps, steps_rayleigh):
    """The second step takes the two paths: its configuration says so, and
    the damping changes the winds of the top levels and no others."""
    cfg = steps_rayleigh["tcore"].config
    assert cfg.tau > 0.0 and not cfg.rf_fast and not cfg.tracer_dynamic_subcycle
    u0, u1 = steps["got"].u, steps_rayleigh["got"].u
    changed = (u0 != u1).flatten(2).any(dim=2).any(dim=0)  # by level
    assert changed[:3].all() and not changed[3:].any()


def test_hydrostatic_step_transports_two_fields_in_one_multi_call(steps):
    """d_sw of the hydrostatic configuration sends pt and the vorticity
    through one multi-field transport per substep (no w)."""
    assert steps["multi_calls"] == [2] * 5


def test_hydrostatic_step_conserves_dry_and_tracer_mass(steps):
    before, after, grid = steps["tstate"], steps["got"], steps["tgrid"]
    i = (..., slice(H, -H), slice(H, -H))
    area = grid.area[i][:, None]

    def masses(st):
        dm = st.delp[i] * area
        return float(dm.sum()), float((st.q[i] * dm[:, None]).sum())

    (m0, q0), (m1, q1) = masses(before), masses(after)
    assert abs(m1 - m0) <= 1e-12 * m0
    assert abs(q1 - q0) <= 1e-12 * q0
