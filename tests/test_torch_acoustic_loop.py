"""The port's acoustic substep and loop against pace_tpu's.

``_one_substep`` and ``acoustic_loop`` of ``pace_tpu_torch`` against those of
``pace_tpu`` (XLA path), hydrostatic and nonhydrostatic, with beta
off-centering on and off and with ``rf_fast`` Rayleigh damping, from the
Jablonowski-Williamson state with a random ``w`` (numpy, seeded), C12 npz=8,
float64, in the dycore benchmark's D-grid configuration. Tolerance on the
compute domain (fluxes on the interfaces that bound it): rtol 1e-12 with
atol 1e-12 of each output's scale, its largest reference value except for
the outputs of the vertical solve, which are differences of pressures near
1e5 Pa: ``w`` is held to 1e-12 of the largest interface pressure times ``dt
/ dm`` of the lightest layer, ``delz`` to that times ``dt`` (as in
``tests/test_torch_dgrid_slice.py``).
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
from pace_tpu.models.fv3 import acoustics as jacoustics
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.ops import d_sw as jd_sw
from pace_tpu_torch.demos import acoustic_substep as sdemo
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import acoustics
from pace_tpu_torch.models.fv3.state import DycoreState

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
DT = sdemo.DT
STATE = ("u", "v", "w", "delp", "pt", "delz")
FLUXES = ("mfx", "mfy", "cx", "cy", "xfx", "yfx", "heat")
LOOP = ("u", "v", "w", "delp", "pt", "delz", "mfxd", "mfyd", "cxd", "cyd", "xfxd", "yfxd",
        "diss_est")

#: configurations: (hydrostatic, beta, rf_fast)
CONFIGS = {
    "hydrostatic": (True, 0.0, False),
    "hydrostatic_beta": (True, 0.3, False),
    "nonhydrostatic_rf_fast": (False, 0.0, True),
    "nonhydrostatic_beta": (False, 0.3, True),
}


def _cfg(hydrostatic, beta, rf_fast, n_split=1):
    base = sdemo.bench_config(hydrostatic)
    return dataclasses.replace(base, n_split=n_split, beta=beta, rf_fast=rf_fast, tau=10.0,
                               rf_cutoff=3000.0)


def _jcfg(tcfg):
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    fields["d_sw"] = jd_sw.DSWConfig(**dataclasses.asdict(tcfg.d_sw))
    return jacoustics.AcousticConfig(**fields)


@pytest.fixture(scope="module")
def setup():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    w = 0.5 * np.random.default_rng(0).standard_normal(jstate.delp.shape)
    jstate = dataclasses.replace(jstate, w=jnp.asarray(w))
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    thalo = MetricTerms.generate(GridSpec(n_tile=N, npz=NPZ, layout=(1, 1))).halo
    delp = sarrays["delp"][..., H:-H, H:-H]
    pe_max = float(jgrid.ptop + delp.sum(axis=1).max())
    p_err = pe_max * DT / (float(delp.min()) / jconstants.GRAV)
    return dict(jgrid=jgrid, jhalo=mt.halo, jstate=jstate, tgrid=tgrid, thalo=thalo,
                tstate=tstate, scales={"w": p_err, "delz": p_err * DT})


def _check(s, got, want, names):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        dy, dx = b.shape[-2] - (N + 2 * H), b.shape[-1] - (N + 2 * H)
        region = np.s_[..., H:H + N + dy, H:H + N + dx]
        a, b = a[region], b[region]
        assert np.isfinite(a).all(), name
        scale = max(np.abs(b).max(), s["scales"].get(name, 0.0))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def _substep_args(st, hydrostatic):
    return (st.u, st.v, None if hydrostatic else st.w, st.delp, st.pt,
            None if hydrostatic else st.delz, st.phis)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_substep_matches(setup, name):
    hydrostatic, beta, rf_fast = CONFIGS[name]
    s = setup
    tcfg = _cfg(hydrostatic, beta, rf_fast)
    js, ts = s["jstate"], s["tstate"]
    # beta with a carried increment (hydrostatic) or the seeding first
    # substep (nonhydrostatic: no increment yet)
    rng = np.random.default_rng(1)
    dugf = None
    if beta and hydrostatic:
        dugf = (0.01 * rng.standard_normal(js.u.shape), 0.01 * rng.standard_normal(js.v.shape))
    want = jacoustics._one_substep(
        *_substep_args(js, hydrostatic), s["jgrid"], s["jhalo"], _jcfg(tcfg), DT, 0.5 * DT,
        s["jgrid"].ptop, dugf_prev=None if dugf is None else tuple(jnp.asarray(a) for a in dugf))
    got = acoustics._one_substep(
        *_substep_args(ts, hydrostatic), s["tgrid"], s["thalo"], tcfg, DT, 0.5 * DT,
        s["tgrid"].ptop, dugf_prev=None if dugf is None else tuple(torch.from_numpy(a)
                                                                    for a in dugf))
    assert len(got) == len(want)
    _check(s, got[:13], want[:13], STATE + FLUXES)
    if beta:
        _check(s, got[13], want[13], ("u", "v"))


@pytest.mark.parametrize("name", ["hydrostatic_beta", "nonhydrostatic_beta"])
def test_acoustic_loop_matches(setup, name):
    hydrostatic, beta, rf_fast = CONFIGS[name]
    s = setup
    tcfg = _cfg(hydrostatic, beta, rf_fast, n_split=2)
    js, ts = s["jstate"], s["tstate"]
    dt_k = 2 * DT
    want = jacoustics.acoustic_loop(
        *_substep_args(js, hydrostatic)[:5], js.phis, s["jgrid"], s["jhalo"], _jcfg(tcfg), dt_k,
        delz=None if hydrostatic else js.delz)
    got = acoustics.acoustic_loop(
        *_substep_args(ts, hydrostatic)[:5], ts.phis, s["tgrid"], s["thalo"], tcfg, dt_k,
        delz=None if hydrostatic else ts.delz)
    _check(s, [getattr(got, n) for n in LOOP], [getattr(want, n) for n in LOOP], LOOP)


def test_loop_result_fields_are_pace_tpu_s():
    assert ([f.name for f in dataclasses.fields(acoustics.AcousticResult)]
            == [f.name for f in dataclasses.fields(jacoustics.AcousticResult)])


def test_nonhydrostatic_loop_needs_w_and_delz(setup):
    s = setup
    ts = s["tstate"]
    with pytest.raises(ValueError, match="requires w and delz"):
        acoustics.acoustic_loop(ts.u, ts.v, None, ts.delp, ts.pt, ts.phis, s["tgrid"],
                                s["thalo"], _cfg(False, 0.0, False), DT)
