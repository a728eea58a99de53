"""The dycore's saturation adjustment in the port against pace_tpu's.

``sat_adjust`` and ``cloud_fraction`` of ``pace_tpu_torch.ops.dycore_extras``
against their ``pace_tpu`` namesakes (XLA, CPU) on the same numpy inputs (the
moist baroclinic-wave state at C12 npz=8 with the tracer block of
``demos.physics_step.moist_tracers``, float64), then one nonhydrostatic
``step_dynamics`` with ``do_sat_adj=True, do_qa=True`` and the dycore
benchmark's flags at ``k_split=2, n_split=2`` against ``pace_tpu``'s, held on
the compute domain as ``tests/test_torch_dycore.py`` holds the step.
Tolerance: rtol 1e-12 with atol 1e-12 of each field's scale. Then the oracle
properties of ``tests/main/test_dycore_extras2.py``'s ``sat_adjust`` and
``cloud_fraction`` cases on the port's side, the cloud fraction in [0, 1],
and the step's conservation of the water species and the other tracers.
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
from pace_tpu.ops import dycore_extras as jx
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.models.shield import microphysics as tmp
from pace_tpu_torch.ops import dycore_extras as tx

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
K_SPLIT, N_SPLIT = 2, 2
WATER = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd", "q_con")


@pytest.fixture(scope="module")
def states():
    """pace_tpu's and the port's grid and moist state from the same numpy
    arrays, and the layer inputs of sat_adjust."""
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
    tstate.q_con = torch.zeros_like(tstate.delp)
    jstate = dataclasses.replace(jstate, q=jnp.asarray(q), q_con=jnp.zeros_like(jstate.delp))
    peln = sarrays["peln"]
    layer = {n: q[:, TRACER_NAMES.index(n)] for n in WATER}
    layer.update(pt=sarrays["pt"], pkz=sarrays["pkz"],
                 p_mid=sarrays["delp"] / (peln[:, 1:] - peln[:, :-1]))
    return dict(jgrid=jgrid, jhalo=mt.halo, jstate=jstate,
                tgrid=GridData.from_numpy(garrays, device="cpu", dtype=torch.float64),
                thalo=MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo,
                tstate=tstate, layer=layer)


def _close(got, want, name="", scale=None):
    if want is None:
        assert got is None, name
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("case", ["six species", "vapor and liquid", "no qa", "icloud_f 1"])
def test_sat_adjust_matches(states, case):
    c = states["layer"]
    names = WATER if case != "vapor and liquid" else WATER[:2]
    kw = dict(do_qa=case != "no qa", icloud_f=1 if case == "icloud_f 1" else 0,
              tau_v2l=90.0)
    args = [c["pt"]] + [c[n] for n in names]
    want = jx.sat_adjust(*(jnp.asarray(a) for a in args), p_mid=jnp.asarray(c["p_mid"]),
                         pkz=jnp.asarray(c["pkz"]), dt=50.0, config=jmp.MicrophysicsConfig(**kw))
    got = tx.sat_adjust(*(torch.from_numpy(np.array(a)) for a in args),
                        p_mid=torch.from_numpy(np.array(c["p_mid"])),
                        pkz=torch.from_numpy(np.array(c["pkz"])), dt=50.0,
                        config=tmp.MicrophysicsConfig(**kw))
    for name, a, b in zip(("pt",) + WATER + ("qa",), got, want):
        _close(a, b, name)


def test_cloud_fraction_matches(states):
    c = states["layer"]
    t = c["pt"] * c["pkz"] / (1.0 + constants.ZVIR * c["qvapor"])
    args = (c["qvapor"], c["qliquid"], t, c["p_mid"])
    for kw in ({}, dict(rh_crit=0.6, ql_full=1e-4)):
        _close(tx.cloud_fraction(*(torch.from_numpy(np.array(a)) for a in args), **kw),
               jx.cloud_fraction(*(jnp.asarray(a) for a in args), **kw), str(kw))


def _cores(states, **over):
    cfg = ddemo.bench_config(NPZ, k_split=K_SPLIT, n_split=N_SPLIT, **over)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return (jdycore.DynamicalCore(states["jgrid"], states["jhalo"],
                                  jdycore.DynamicalCoreConfig(**kw), timestep=ddemo.TIMESTEP),
            dycore.DynamicalCore(states["tgrid"], states["thalo"],
                                 dycore.DynamicalCoreConfig(**kw), timestep=ddemo.TIMESTEP))


@pytest.fixture(scope="module")
def steps(states):
    jcore, tcore = _cores(states, do_sat_adj=True, do_qa=True)
    return dict(want=jcore.step_dynamics(states["jstate"]),
                got=tcore.step_dynamics(states["tstate"]))


def _region(shape):
    dy, dx = shape[-2] - (N + 2 * H), shape[-1] - (N + 2 * H)
    return np.s_[..., H:H + N + dy, H:H + N + dx]


@pytest.mark.parametrize("name", FIELDS)
def test_step_with_sat_adj_matches(states, steps, name):
    want = np.asarray(getattr(steps["want"], name))
    got = getattr(steps["got"], name)
    region = _region(want.shape)
    delp = np.asarray(states["jstate"].delp)[..., H:-H, H:-H]
    pe_max = float(states["jgrid"].ptop + delp.sum(axis=1).max())
    dt = ddemo.TIMESTEP / (K_SPLIT * N_SPLIT)
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    scales = {"w": p_err, "delz": p_err * dt, "omga": pe_max * K_SPLIT / ddemo.TIMESTEP}
    _close(got[region], want[region], name,
           scale=max(np.abs(want[region]).max(), scales.get(name, 0.0)))


def test_step_with_sat_adj_conserves_water_and_other_tracers(states, steps):
    """The adjustment moves water between the species and overwrites qcld
    with the cloud fraction; the six species' mass and every other tracer's
    are conserved as the step conserves them, and qcld lies in [0, 1]."""
    i = (..., slice(H, -H), slice(H, -H))
    area = states["tgrid"].area[i][:, None]

    def masses(st, idx):
        dm = st.delp[i] * area
        return float((st.q[:, idx][i] * dm[:, None]).sum())

    before, after = states["tstate"], steps["got"]
    water = [TRACER_NAMES.index(n) for n in WATER]
    assert masses(after, water) == pytest.approx(masses(before, water), rel=1e-12)
    for n in ("qo3mr", "qsgs_tke"):
        k = [TRACER_NAMES.index(n)]
        assert masses(after, k) == pytest.approx(masses(before, k), rel=1e-12), n
    qcld = after.q[:, TRACER_NAMES.index("qcld")][i]
    assert float(qcld.min()) >= 0.0 and float(qcld.max()) <= 1.0
    assert float(qcld.max()) > 0.05  # some cloud was diagnosed


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

def _point(v):
    return torch.full((1, 1, 1, 1), v, dtype=torch.float64)


def test_sat_adjust_condenses_supersaturation():
    pkz, p, qv, ql = _point(0.95), _point(9.0e4), _point(0.03), _point(0.0)
    pt = 285.0 * (1.0 + constants.ZVIR * qv) / pkz
    pt2, qv2, ql2, *_ice, _qa = tx.sat_adjust(pt, qv, ql, p_mid=p, pkz=pkz, dt=600.0)
    assert float(qv2) < 0.03 and float(ql2) > 0.0
    assert float(pt2 * pkz / (1.0 + constants.ZVIR * qv2)) > 285.0  # latent heating
    assert float(qv2 + ql2) == pytest.approx(0.03, rel=1e-12)
    assert _ice == [None] * 4


def test_sat_adjust_evaporates_in_dry_air():
    pkz, p, qv, ql = _point(0.95), _point(9.0e4), _point(1.0e-4), _point(1.0e-3)
    pt = 290.0 * (1.0 + constants.ZVIR * qv) / pkz
    pt2, qv2, ql2, *_rest = tx.sat_adjust(pt, qv, ql, p_mid=p, pkz=pkz, dt=600.0)
    assert float(qv2) > 1.0e-4 and float(ql2) < 1.0e-3
    assert float(pt2 * pkz / (1.0 + constants.ZVIR * qv2)) < 290.0  # evaporative cooling


def test_tau_v2l_changes_the_answer():
    pkz, p, qv = _point(0.95), _point(9.0e4), _point(0.03)
    pt = 285.0 * (1.0 + constants.ZVIR * qv) / pkz
    a, b = (tx.sat_adjust(pt, qv, torch.zeros_like(qv), p_mid=p, pkz=pkz, dt=60.0,
                          config=tmp.MicrophysicsConfig(tau_v2l=tau))
            for tau in (150.0, 1500.0))
    assert float(a[1]) != float(b[1])


def test_cloud_fraction_limits():
    t = torch.full((4,), 280.0, dtype=torch.float64)
    p = torch.full((4,), 8.0e4, dtype=torch.float64)
    qv = torch.tensor([1e-4, 1e-4, 8e-3, 6.3e-3], dtype=torch.float64)
    ql = torch.tensor([0.0, 5e-4, 0.0, 0.0], dtype=torch.float64)
    qa = tx.cloud_fraction(qv, ql, t, p)
    assert float(qa[0]) == 0.0 and float(qa[1]) == 1.0
    assert float(qa[2]) > 0.9 and 0.0 < float(qa[3]) < 1.0


def test_diagnosed_cloud_fraction_lies_in_the_unit_interval(states):
    c = states["layer"]
    out = tx.sat_adjust(*(torch.from_numpy(np.array(c[n])) for n in ("pt",) + WATER),
                        p_mid=torch.from_numpy(np.array(c["p_mid"])),
                        pkz=torch.from_numpy(np.array(c["pkz"])),
                        dt=100.0, config=tmp.MicrophysicsConfig(do_qa=True))
    qa = out[-1]
    assert float(qa.min()) >= 0.0 and float(qa.max()) <= 1.0
    assert float(qa.min()) == 0.0 and float(qa.max()) == 1.0
