"""The per-stage sanitizer: ``tests/main/test_sanitizer.py`` against the
port, with ``pace_tpu``'s sanitizer as the oracle of the first failing
stage and of the messages.

A clean hydrostatic step at C12, npz=4 passes every stage; a NaN seeded in
the input is caught at the first stage, the stage ``pace_tpu``'s sanitizer
names, with ``pace_tpu``'s message; the negative-``delp`` and
negative-tracer checks report what ``pace_tpu``'s report. Through the
driver, ``debug_checks: true`` runs clean on ``baroclinic_c12.yaml``'s
dycore and raises ``SanitizerError`` at ``FVDynamics-In`` for a NaN in
``delp``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.fv3.dycore import DynamicalCore as JDynamicalCore
from pace_tpu.models.fv3.dycore import DynamicalCoreConfig as JDynamicalCoreConfig
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.testing import sanitizer as jsan
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.testing import SanitizerCheckpointer, SanitizerError
from pace_tpu_torch.testing.sanitizer import make_sanitizer
from pace_tpu_torch.utils import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(npz=4, k_split=1, n_split=1, hydrostatic=True, nord=1, d4_bg=0.12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device="cpu", dtype=torch.float64)
    state = DycoreState.from_analytic_init(mt, device="cpu", dtype=torch.float64)
    return mt, grid, DynamicalCoreConfig(**CFG), state


def test_clean_run_passes(model):
    mt, grid, cfg, state = model
    san = SanitizerCheckpointer(progress=True)
    DynamicalCore(grid, mt.halo, cfg, 300.0, checkpointer=san).step_dynamics(state)
    # FVDynamics-In, C_SW-In/Out, D_SW-Out, Tracer2D1L-In/Out, Remapping-In/Out,
    # FVDynamics-Out
    assert san._hit == 9


def test_nan_input_caught_at_pace_tpu_s_first_stage(model):
    mt, grid, cfg, state = model
    u = state.u.clone()
    u[0, 0, 8, 8] = float("nan")
    with pytest.raises(SanitizerError, match="non-finite") as got:
        DynamicalCore(grid, mt.halo, cfg, 300.0, checkpointer=SanitizerCheckpointer()
                      ).step_dynamics(dataclasses.replace(state, u=u))
    jmt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jstate = JDycoreState.from_baroclinic_init(jmt, dtype=jnp.float64)
    ju = np.asarray(jstate.u).copy()
    ju[0, 0, 8, 8] = np.nan
    with pytest.raises(jsan.SanitizerError) as want:
        JDynamicalCore(JGridData.from_metric_terms(jmt, dtype=jnp.float64), jmt.halo,
                       JDynamicalCoreConfig(**CFG), 300.0,
                       checkpointer=jsan.SanitizerCheckpointer()
                       ).step_dynamics(dataclasses.replace(jstate, u=jnp.asarray(ju)))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("FVDynamics-In.u:")


def test_negative_delp_and_tracer_checks():
    q = np.zeros((1, 2, 2))
    q[0, 0, 0] = -1.0e-3
    delp = np.ones((1, 2, 2))
    delp[0, 1, 1] = -5.0
    msgs = []
    for cls, arr in ((SanitizerCheckpointer, torch.from_numpy), (jsan.SanitizerCheckpointer,
                                                                  jnp.asarray)):
        san = cls(collect=True)
        san("D_SW-Out", delp=arr(delp), q=arr(q))
        msgs.append(san.failures)
    assert msgs[0] == msgs[1]
    assert any("non-positive layer" in f for f in msgs[0])
    assert any("below" in f for f in msgs[0])
    # tiny negatives above the floor are tolerated (neg_adj3 territory)
    san2 = SanitizerCheckpointer(collect=True)
    san2("X", q=torch.full((2, 2), -1.0e-12, dtype=torch.float64))
    assert san2.failures == []
    # the halo is not checked
    q = torch.zeros((1, 9, 9), dtype=torch.float64)
    q[0, 0, 0] = float("nan")
    san3 = SanitizerCheckpointer(collect=True)
    san3("X", q=q)
    assert san3.failures == []


def test_make_sanitizer_is_pace_tpu_s():
    cfg = {"tracer_floor": -1e-6, "progress": True, "n_halo": 2}
    for c in (None, cfg):
        a, b = make_sanitizer(c), jsan.make_sanitizer(c)
        assert (a.tracer_floor, a.progress, a.n_halo, a.collect) == (
            b.tracer_floor, b.progress, b.n_halo, b.collect)


def test_driver_debug_checks(tmp_path):
    with open(os.path.join(ROOT, "examples", "configs", "baroclinic_c12.yaml")) as f:
        raw = yaml_subset.safe_load(f)
    raw.update(nz=8, minutes=0, seconds=225, debug_checks=True)
    raw["diagnostics_config"]["path"] = str(tmp_path / "output")
    raw["performance_config"]["experiment_name"] = str(tmp_path / "exp")
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    assert isinstance(d.dycore.checkpointer, SanitizerCheckpointer)
    d.step_all()
    d.cleanup()
    assert d._step_count == 1 and d.dycore.checkpointer._hit == 1 + 3 * 5 + 4 + 1
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    delp = d.state.delp.clone()
    delp[0, 3, 8, 8] = float("nan")
    d.state = dataclasses.replace(d.state, delp=delp)
    with pytest.raises(SanitizerError, match=r"^FVDynamics-In\.delp: 1 non-finite"):
        d.step_all()
