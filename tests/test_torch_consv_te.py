"""The total-energy fixer (``consv_te > 0``) of the port against pace_tpu's.

``total_energy_columns`` and ``global_energy_fix_increment`` of
``pace_tpu_torch.ops.dycore_extras`` against ``pace_tpu``'s on seeded
float64 fields with the halo (rtol 1e-12); the oracle properties of
``tests/main/test_consv_te.py`` on the port's side (with dry air the fix
restores the global energy integral, and dry ``cvm`` is ``CV_AIR``); then one
whole ``DynamicalCore`` step with ``consv_te = 1`` at C12 npz=8, float64, from
the Jablonowski-Williamson state with a seeded moist tracer block (so that
``cvm`` is not ``CV_AIR``), against ``pace_tpu``'s step: nonhydrostatic with
the dycore benchmark's flags at ``k_split=2, n_split=2`` (two increments a
step) and hydrostatic with ``examples/configs/baroclinic_c12.yaml``'s flag
set. Held on the compute domain within rtol 1e-12 and 1e-12 of each field's
scale, as ``tests/test_torch_dycore.py`` holds the step without the fixer.
Last, what the step refuses and that the fixer adds no work where
``consv_te`` is 0.
"""

import dataclasses
import os

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
from pace_tpu.ops import dycore_extras as jextras
from pace_tpu_torch import constants
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.ops import dycore_extras
from pace_tpu_torch.ops.moist_cv import moist_cv

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
K_SPLIT, N_SPLIT = 2, 2
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd", "q_con")
C12_YAML = os.path.join(os.path.dirname(__file__), "..", "examples", "configs",
                        "baroclinic_c12.yaml")


@pytest.fixture(scope="module")
def grids():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    thalo = MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo
    return dict(mt=mt, jgrid=jgrid, tgrid=tgrid, thalo=thalo)


def _fields(seed, K=4):
    """u, v, w, delp, pt, pkz, phis with the halo, on the C12 cube."""
    rng = np.random.default_rng(seed)
    Y = X = N + 2 * H
    return dict(u=rng.standard_normal((6, K, Y + 1, X)) * 10.0,
                v=rng.standard_normal((6, K, Y, X + 1)) * 10.0,
                w=rng.standard_normal((6, K, Y, X)) * 0.5,
                delp=200.0 + 20.0 * rng.random((6, K, Y, X)),
                pt=280.0 + 30.0 * rng.random((6, K, Y, X)),
                pkz=0.3 + 0.5 * rng.random((6, K, Y, X)),
                phis=1000.0 * rng.random((6, Y, X)))


def _torch(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_w", [True, False], ids=["nonhydrostatic", "hydrostatic"])
def test_total_energy_columns_matches(with_w):
    f = _fields(3)
    if not with_w:
        f["w"] = None
    args = [f[k] for k in ("u", "v", "w", "delp", "pt", "pkz", "phis")]
    want = np.asarray(jextras.total_energy_columns(
        *(None if a is None else jnp.asarray(a) for a in args)))
    got = dycore_extras.total_energy_columns(*(None if a is None else _torch(a) for a in args))
    assert got.shape == want.shape == (6, N + 2 * H, N + 2 * H)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _moist_q(seed, K=4):
    rng = np.random.default_rng(seed)
    return 1e-3 * rng.random((6, 9, K, N + 2 * H, N + 2 * H))


def test_global_energy_fix_increment_matches(grids):
    f1, f2 = _fields(4), _fields(5)
    q = _moist_q(6)
    te1 = jextras.total_energy_columns(*(jnp.asarray(f1[k]) for k in
                                         ("u", "v", "w", "delp", "pt", "pkz", "phis")))
    te2 = jextras.total_energy_columns(*(jnp.asarray(f2[k]) for k in
                                         ("u", "v", "w", "delp", "pt", "pkz", "phis")))
    from pace_tpu.ops.moist_cv import moist_cv as jmoist_cv

    jcvm, _ = jmoist_cv(jnp.asarray(q), 6)
    want = float(jextras.global_energy_fix_increment(
        te1, te2, jcvm, jnp.asarray(f2["delp"]), grids["jgrid"].area, H, 0.7))
    cvm, _ = moist_cv(_torch(q), 6)
    got = dycore_extras.global_energy_fix_increment(
        _torch(te1), _torch(te2), cvm, _torch(f2["delp"]), grids["tgrid"].area, H, 0.7)
    assert got.ndim == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_fix_restores_global_energy_integral(grids):
    """Dry air, layout (1, 1): cvm is CV_AIR, so pt += dT / pkz puts the
    area-weighted global energy integral back to its value before the
    (here: a cooling of pt by 0.5%) remap."""
    f = {k: _torch(v) for k, v in _fields(12).items()}
    te1 = dycore_extras.total_energy_columns(f["u"], f["v"], f["w"], f["delp"], f["pt"],
                                             f["pkz"], f["phis"])
    pt2 = f["pt"] * 0.995
    te2 = dycore_extras.total_energy_columns(f["u"], f["v"], f["w"], f["delp"], pt2, f["pkz"],
                                             f["phis"])
    cvm, _ = moist_cv(torch.zeros((6, 6) + tuple(f["delp"].shape[1:]), dtype=torch.float64), 6)
    area = grids["tgrid"].area
    dT = dycore_extras.global_energy_fix_increment(te1, te2, cvm, f["delp"], area, H, 1.0)
    te3 = dycore_extras.total_energy_columns(f["u"], f["v"], f["w"], f["delp"],
                                             pt2 + dT / f["pkz"], f["pkz"], f["phis"])
    sl = (..., slice(H, -H), slice(H, -H))
    before = float((te1[sl] * area[sl]).sum())
    after = float((te3[sl] * area[sl]).sum())
    np.testing.assert_allclose(after, before, rtol=1e-12)
    assert float(dT) > 0.0  # the increment heats a cooled state


def test_dry_cvm_is_cv_air():
    cvm, _ = moist_cv(torch.zeros((2, 6, 4, 4, 4), dtype=torch.float64), 6)
    assert torch.equal(cvm, torch.full_like(cvm, constants.CV_AIR))


# ---------------------------------------------------------- the whole step

def _bench_kw():
    cfg = ddemo.bench_config(NPZ, k_split=K_SPLIT, n_split=N_SPLIT)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _c12_kw():
    with open(C12_YAML) as f:
        doc = yaml.safe_load(f)
    return dict(doc["dycore_config"], npz=NPZ), float(doc["dt_atmos"])


def _step(grids, kw, timestep, seed):
    """One step of each implementation with the fixer on, from the
    perturbed baroclinic-wave state with a moist tracer block."""
    jgrid, tgrid = grids["jgrid"], grids["tgrid"]
    jstate = JDycoreState.from_baroclinic_init(grids["mt"], perturbation=True,
                                               dtype=jnp.float64)
    q = 1e-3 * np.random.default_rng(seed).random(jstate.q.shape) + 1e-4
    jstate = dataclasses.replace(jstate, q=jnp.asarray(q), q_con=jnp.zeros_like(jstate.delp))
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    kw = dict(kw, consv_te=1.0)
    jcore = jdycore.DynamicalCore(jgrid, grids["mt"].halo, jdycore.DynamicalCoreConfig(**kw),
                                  timestep=timestep)
    tcore = dycore.DynamicalCore(tgrid, grids["thalo"], dycore.DynamicalCoreConfig(**kw),
                                 timestep=timestep)
    delp = sarrays["delp"][..., H:-H, H:-H]
    pe_max = float(jgrid.ptop + delp.sum(axis=1).max())
    dt = timestep / (kw["k_split"] * kw["n_split"])
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    return dict(want=jcore.step_dynamics(jstate), got=tcore.step_dynamics(tstate), tcore=tcore,
                scales={"w": p_err, "delz": p_err * dt,
                        "omga": pe_max * kw["k_split"] / timestep})


@pytest.fixture(scope="module")
def steps(grids):
    c12_kw, c12_dt = _c12_kw()
    return {"nonhydrostatic": _step(grids, _bench_kw(), ddemo.TIMESTEP, 0),
            "hydrostatic": _step(grids, c12_kw, c12_dt, 1)}


def _region(shape):
    dy, dx = shape[-2] - (N + 2 * H), shape[-1] - (N + 2 * H)
    return np.s_[..., H:H + N + dy, H:H + N + dx]


@pytest.mark.parametrize("case", ["nonhydrostatic", "hydrostatic"])
@pytest.mark.parametrize("name", FIELDS)
def test_step_with_the_fixer_matches(steps, case, name):
    s = steps[case]
    want = getattr(s["want"], name)
    if want is None:
        assert getattr(s["got"], name) is None
        return
    want = np.asarray(want)
    got = getattr(s["got"], name).numpy()
    assert got.shape == want.shape
    region = _region(want.shape)
    got, want = got[region], want[region]
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), s["scales"].get(name, 0.0))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("case", ["nonhydrostatic", "hydrostatic"])
def test_step_records_one_increment_an_outer_step(steps, case):
    tcore = steps[case]["tcore"]
    dts = tcore.energy_fix_dT
    assert len(dts) == tcore.config.k_split
    assert all(t.ndim == 0 and bool(torch.isfinite(t)) and float(t) != 0.0 for t in dts)


def test_consv_te_is_taken_and_sat_adj_still_refused(grids):
    """consv_te is taken, alone and beside do_sat_adj (which the dycore
    refused until the saturation adjustment was ported); a checkpointer is
    still refused."""
    dycore.DynamicalCore(grids["tgrid"], None, dycore.DynamicalCoreConfig(consv_te=1.0), 200.0)
    core = dycore.DynamicalCore(grids["tgrid"], None,
                                dycore.DynamicalCoreConfig(consv_te=1.0, do_sat_adj=True), 200.0)
    assert core.config.do_sat_adj and core.config.consv_te == 1.0
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        dycore.DynamicalCore(grids["tgrid"], None,
                             dycore.DynamicalCoreConfig(consv_te=1.0, do_sat_adj=True), 200.0,
                             checkpointer=lambda *a, **k: None)


def test_without_consv_te_the_fixer_does_no_work(monkeypatch):
    """consv_te = 0: no energy column, no increment, nothing recorded."""
    def refuse(*a, **k):
        raise AssertionError("the energy fixer ran with consv_te = 0")

    monkeypatch.setattr(dycore, "total_energy_columns", refuse)
    monkeypatch.setattr(dycore, "global_energy_fix_increment", refuse)
    monkeypatch.setattr(dycore, "_lagrangian_pkz", refuse)
    out = ddemo.run(12, 4, warm=0, steps=1, device="cpu", dtype=torch.float64,
                    k_split=1, n_split=1)
    assert out["case"].core.energy_fix_dT == []
