"""The port's dycore step on the doubly-periodic plane (``grid_type=4``)
against pace_tpu's.

Mirrors ``tests/main/test_cartesian_dycore.py::
test_cartesian_bubble_stable_and_conservative``: one 16 x 16 tile of 1 km
cells with no cube corners, npz=10, a resting isothermal atmosphere with a
+2 K Gaussian bubble, nonhydrostatic, ``nord = 1``, ``d4_bg = 0.12``,
``k_split = 1``, ``n_split = 6``, three 6 s steps, float64 on the CPU. After
each step every field of the port is held against ``pace_tpu``'s (XLA path)
on the compute domain (fluxes on the interfaces that bound it) within rtol
1e-12 and 1e-12 of its scale (its largest reference value, or for ``w``,
``delz`` and ``omga`` the scale that a pressure difference near 1e5 Pa sets,
as ``tests/test_torch_dycore.py`` takes it), or within twice the change
that one ulp of pt at random points makes in ``pace_tpu``'s own step, where
that is larger. The acoustic transient of the bubble amplifies rounding: one
ulp of pt moves the accumulated mass fluxes by 0.57e-12, 1.29e-12 and
3.35e-12 of their largest value after the three steps (and the port's
differ from ``pace_tpu``'s by 0.65e-12, 1.73e-12, 3.25e-12), every other
field by less than 1e-12 of its scale. Then the reference test's checks on
the port's state: finite, rising motion, bounded winds and dry mass
conserved to 1e-12.
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
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import dycore
from pace_tpu_torch.models.fv3.state import DycoreState

N, NPZ, H = 16, 10, 3
RTOL = 1e-12
TIMESTEP, N_SPLIT, STEPS = 6.0, 6, 3
SPEC = dict(n_tile=N, npz=NPZ, layout=(1, 1), grid_type=4, dx_const=1000.0, dy_const=1000.0)
CONFIG = dict(npz=NPZ, k_split=1, n_split=N_SPLIT, hydrostatic=False, nord=1, d4_bg=0.12,
              p_fac=0.05)
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd")


def _bubble_state(mt):
    """The reference test's resting hydrostatic atmosphere with a Gaussian
    warm bubble (pt is virtual potential temperature), for pace_tpu."""
    Y = X = N + 2 * H
    ps = np.full((1, Y, X), 1.0e5)
    pe = mt.ak[None, :, None, None] + mt.bk[None, :, None, None] * ps[:, None]
    peln = np.log(np.maximum(pe, 1e-8))
    pk = (pe / jconstants.P_REF) ** jconstants.KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (jconstants.KAPPA * (peln[:, 1:] - peln[:, :-1]))
    pt = 300.0 / pkz
    jj, ii = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    r2 = ((jj - Y / 2.0) ** 2 + (ii - X / 2.0) ** 2) / 3.0**2
    kk = np.arange(NPZ)
    kprof = np.exp(-((kk - NPZ / 2.0) ** 2) / 2.0**2)
    pt = pt + 2.0 * kprof[None, :, None, None] * np.exp(-r2)[None, None] / pkz
    st = {"u": np.zeros((1, NPZ, Y + 1, X)), "v": np.zeros((1, NPZ, Y, X + 1)),
          "delp": pe[:, 1:] - pe[:, :-1], "pt": pt, "phis": np.zeros((1, Y, X)), "ps": ps}
    return JDycoreState._from_init_dict(mt, st, jnp.float64)


@pytest.fixture(scope="module")
def runs():
    mt = JMetricTerms.generate(JGridSpec(**SPEC))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = _bubble_state(mt)
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    thalo = MetricTerms.generate(GridSpec(**SPEC)).halo
    jcore = jdycore.DynamicalCore(jgrid, mt.halo, jdycore.DynamicalCoreConfig(**CONFIG),
                                  timestep=TIMESTEP)
    tcore = dycore.DynamicalCore(tgrid, thalo, dycore.DynamicalCoreConfig(**CONFIG),
                                 timestep=TIMESTEP)
    delp = sarrays["delp"][..., H:-H, H:-H]
    pe_max = float(jgrid.ptop + delp.sum(axis=1).max())
    dt = TIMESTEP / N_SPLIT
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    # the reference's own sensitivity: pt moved by one ulp at random points
    ulp = 1.0 + np.finfo(np.float64).eps * np.random.default_rng(0).choice(
        [-1.0, 0.0, 1.0], size=sarrays["pt"].shape)
    jnudged = dataclasses.replace(jstate, pt=jnp.asarray(sarrays["pt"] * ulp))
    want, got, nudged = [], [], []
    js, ts, jn = jstate, tstate, jnudged
    for _ in range(STEPS):
        js = jcore.step_dynamics(js)
        ts = tcore.step_dynamics(ts)
        jn = jcore.step_dynamics(jn)
        want.append(js)
        got.append(ts)
        nudged.append(jn)
    return dict(want=want, got=got, nudged=nudged, tstate=tstate, area=mt.area[:, H:-H, H:-H],
                scales={"w": p_err, "delz": p_err * dt, "omga": pe_max / TIMESTEP})


def _region(shape):
    dy, dx = shape[-2] - (N + 2 * H), shape[-1] - (N + 2 * H)
    return np.s_[..., H:H + N + dy, H:H + N + dx]


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", FIELDS)
def test_step_matches(runs, step, name):
    want = np.asarray(getattr(runs["want"][step], name))
    got = getattr(runs["got"][step], name).numpy()
    assert got.shape == want.shape
    region = _region(want.shape)
    nudged = np.asarray(getattr(runs["nudged"][step], name))[region]
    got, want = got[region], want[region]
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), runs["scales"].get(name, 0.0))
    atol = max(RTOL * scale, 2.0 * np.abs(nudged - want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


def test_bubble_stable_and_conservative(runs):
    """The reference test's checks, on the port's state after three steps."""
    st = runs["got"][-1]
    interior = np.s_[:, :, H:-H, H:-H]
    w = st.w.numpy()[interior]
    assert np.isfinite(st.delp.numpy()[interior]).all()
    assert np.isfinite(w).all()
    assert w.max() > 1e-3
    assert np.abs(w).max() < 10.0
    area = runs["area"]
    mass0 = float((runs["tstate"].delp.numpy()[interior].sum(axis=1) * area).sum())
    mass1 = float((st.delp.numpy()[interior].sum(axis=1) * area).sum())
    np.testing.assert_allclose(mass1, mass0, rtol=1e-12)
    assert np.abs(st.u.numpy()[interior]).max() < 10.0
