"""The port's SAS convection against pace_tpu's.

``_newton_plume_tq`` and ``sas_step`` of ``pace_tpu_torch.models.shield.sas``
in both modes against their ``pace_tpu`` namesakes (XLA, CPU) on the same
numpy inputs: the A-grid winds, temperature, vapor and cloud water of the
baroclinic-wave state at C12 npz=8 with the tracer block of
``demos.physics_step.moist_tracers`` (with the surface fluxes of
``examples/configs/baroclinic_c12_physics.yaml`` the shallow plume fires in
about a fifth of the columns), and the soundings of ``tests/main/test_sas.py``,
float64. Tolerance: rtol 1e-12 with atol 1e-12 of each output's largest
reference value. Then the oracle properties of ``tests/main/test_sas.py``
on the port's side: exact column conservation of moist static energy, total
water and momentum, rain leaving the column in deep mode only, the gates, and
the CFL cap at any dt.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import sas as jsas
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import sas as tsas
from pace_tpu_torch.models.shield.physics import Physics

RTOL = 1e-12
N, NPZ = 12, 8
DT = 600.0
#: the shallow-convection fluxes of examples/configs/baroclinic_c12_physics.yaml
YAML_FLUXES = dict(sensible_heat_flux=0.02, latent_heat_flux=2.0e-5)
#: tests/main/test_sas.py's closure fluxes
SOUNDING_FLUXES = dict(sensible_heat_flux=0.08, latent_heat_flux=8e-5)
ARGS = ("ua", "va", "t", "qv", "ql", "pe", "p_mid", "delp")
OUTS = ("u_dt", "v_dt", "t", "qv", "ql", "precip")


@pytest.fixture(scope="module")
def cols():
    """Numpy inputs of sas_step from the moist baroclinic-wave state."""
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    ua, va = Physics(case.grid, (), DT)._a_grid_winds(st)
    qv = st.q[:, TRACER_NAMES.index("qvapor")]
    pe = st.pe.numpy()
    return dict(
        ua=ua.numpy(), va=va.numpy(), t=(st.pt * st.pkz / (1.0 + constants.ZVIR * qv)).numpy(),
        qv=qv.numpy(), ql=st.q[:, TRACER_NAMES.index("qliquid")].numpy(), pe=pe,
        p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]), delp=st.delp.numpy(),
    )


def _sounding(kind="unstable", noise=0.0, K=24, NY=4, NX=5):
    """tests/main/test_sas.py's soundings: "unstable" (a shallow cloud under
    an 800 hPa cap), "stable" (dry) or "deep" (buoyant through 450 hPa);
    ``noise`` adds seeded Gaussian temperature noise [K], under which some
    plumes saturate below a non-buoyant level (the cloud is not yet
    established there)."""
    ak = np.linspace(2000.0, 0.0, K + 1)
    bk = np.linspace(0.0, 1.0, K + 1) ** 1.3
    ps = 1.0e5
    pe = (ak[:, None, None] + bk[:, None, None] * ps) * np.ones((K + 1, NY, NX))
    p_mid = 0.5 * (pe[1:] + pe[:-1])
    delp = pe[1:] - pe[:-1]
    if kind == "deep":
        p_cap = 0.45 * ps
        t_ml = 302.0 * (p_mid / ps) ** 0.2857
        t_cap = 302.0 * (p_cap / ps) ** 0.2857
        t = np.maximum(np.where(p_mid > p_cap, t_ml, t_cap * (p_mid / p_cap) ** 0.10), 195.0)
    else:
        unstable = kind == "unstable"
        t_sfc = 300.0 if unstable else 280.0
        kappa = 0.2857 if unstable else 0.12
        p_cap = 0.8 * ps
        t_ml = t_sfc * (p_mid / ps) ** kappa
        t_cap = t_sfc * (p_cap / ps) ** kappa
        t = np.maximum(np.where(p_mid > p_cap, t_ml, t_cap * (p_mid / p_cap) ** 0.12), 200.0)
    qsat = 0.622 * 611.21 * np.exp(17.502 * (t - 273.16) / (t - 273.16 + 240.97)) \
        / np.maximum(p_mid - 611.21, 1.0)
    if kind == "deep":
        qv = np.minimum(0.9 * qsat, 0.02)
    else:
        qv = np.minimum((0.9 if kind == "unstable" else 0.3) * (p_mid / ps) ** 0.5 * qsat, 0.018)
        if kind == "unstable":
            qv[-1] = 0.018
    rng = np.random.RandomState(7)
    t = t + noise * np.random.default_rng(0).standard_normal(t.shape)
    return dict(ua=3.0 + 0.5 * rng.randn(K, NY, NX), va=-2.0 + 0.5 * rng.randn(K, NY, NX),
                t=t, qv=qv, ql=np.zeros_like(qv), pe=pe, p_mid=p_mid, delp=delp)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_newton_plume_tq_matches(cols):
    rng = np.random.default_rng(5)
    t, p_mid = cols["t"], cols["p_mid"]
    z = rng.uniform(0.0, 15000.0, t.shape)
    qt = cols["qv"] * rng.uniform(0.5, 1.5, t.shape)
    h = constants.CP_AIR * (t + rng.uniform(-2.0, 2.0, t.shape)) + constants.GRAV * z \
        + constants.HLV * np.minimum(qt, cols["qv"])
    args = (h, qt, z, p_mid, t)
    got = tsas._newton_plume_tq(*_t(*args))
    want = jsas._newton_plume_tq(*_j(*args))
    for name, a, b in zip(("t", "qv", "ql"), got[:3], want[:3]):
        _close(a, b, name)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))


CASES = {
    "shallow state": ("state", tsas.ShallowConvectionConfig, YAML_FLUXES),
    "deep state": ("state", tsas.DeepConvectionConfig, YAML_FLUXES),
    "shallow sounding": (("unstable",), tsas.ShallowConvectionConfig, SOUNDING_FLUXES),
    "deep sounding": (("deep",), tsas.DeepConvectionConfig, dict(sensible_heat_flux=0.05,
                                                                 latent_heat_flux=5e-5)),
    "no momentum, no detrainment": (("unstable",), tsas.ShallowConvectionConfig,
                                    dict(SOUNDING_FLUXES, mix_momentum=False,
                                         detrain_liquid=False)),
    "stable sounding": (("stable",), tsas.ShallowConvectionConfig, {}),
    # temperature noise: clouds that saturate below a non-buoyant level
    "shallow noisy sounding": (("unstable", 1.0), tsas.ShallowConvectionConfig,
                               SOUNDING_FLUXES),
    "deep noisy sounding": (("deep", 3.0), tsas.DeepConvectionConfig, SOUNDING_FLUXES),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sas_step_matches(cols, case):
    where, cls, kw = CASES[case]
    c = cols if where == "state" else _sounding(*where)
    jcls = getattr(jsas, cls.__name__)
    args = [c[n] for n in ARGS]
    got = tsas.sas_step(*_t(*args), DT, cls(**kw))
    want = jsas.sas_step(*_j(*args), DT, jcls(**kw))
    for name, a, b in zip(OUTS, got, want):
        _close(a, b, f"{case} {name}")
    if where != ("stable",):
        assert float((got[2] - torch.from_numpy(c["t"])).abs().max()) > 1e-4  # the plume fired


def test_sas_step_with_flux_arrays_matches(cols):
    rng = np.random.default_rng(6)
    shape = cols["t"][:, 0].shape
    shf, lhf = rng.uniform(0.0, 0.05, shape), rng.uniform(0.0, 5e-5, shape)
    args = [cols[n] for n in ARGS]
    got = tsas.sas_step(*_t(*args), DT, tsas.ShallowConvectionConfig(),
                        sensible_heat_flux=torch.from_numpy(shf),
                        latent_heat_flux=torch.from_numpy(lhf))
    want = jsas.sas_step(*_j(*args), DT, jsas.ShallowConvectionConfig(),
                         sensible_heat_flux=jnp.asarray(shf), latent_heat_flux=jnp.asarray(lhf))
    for name, a, b in zip(OUTS, got, want):
        _close(a, b, name)


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

def _columns(delp, *fields):
    return [(f * delp).sum(dim=-3) for f in fields]


@pytest.mark.parametrize("where", ["state", "unstable"])
def test_shallow_conserves_the_column(cols, where):
    c = cols if where == "state" else _sounding(where)
    ua, va, t, qv, ql, pe, p_mid, delp = _t(*(c[n] for n in ARGS))
    kw = YAML_FLUXES if where == "state" else SOUNDING_FLUXES
    u_dt, v_dt, t1, qv1, ql1, precip = tsas.sas_step(ua, va, t, qv, ql, pe, p_mid, delp, DT,
                                                     tsas.ShallowConvectionConfig(**kw))
    cp, lv = constants.CP_AIR, constants.HLV
    (qt0, h0), (qt1, h1) = (_columns(delp, q_v + q_l, cp * tt + lv * q_v)
                            for q_v, q_l, tt in ((qv, ql, t), (qv1, ql1, t1)))
    np.testing.assert_allclose(qt1.numpy(), qt0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-12)
    for w, w_dt in ((ua, u_dt), (va, v_dt)):
        m0, m1 = _columns(delp, w, w + DT * w_dt)
        np.testing.assert_allclose(m1.numpy(), m0.numpy(), rtol=1e-12, atol=1e-9)
    assert float(precip.abs().max()) == 0.0
    assert float(qv1.min()) >= 0.0 and float(ql1.min()) >= 0.0
    if where == "unstable":
        # the plume dries the source layer and moistens above
        dq = qv1 - qv
        assert float(dq[-1].mean()) < 0.0 and float(dq.max()) > 0.0


def test_deep_precipitates_and_conserves_moist_static_energy():
    ua, va, t, qv, ql, pe, p_mid, delp = _t(*(_sounding("deep")[n] for n in ARGS))
    cfg = tsas.DeepConvectionConfig(sensible_heat_flux=0.05, latent_heat_flux=5e-5)
    _, _, t1, qv1, ql1, precip = tsas.sas_step(ua, va, t, qv, ql, pe, p_mid, delp, DT, cfg)
    g, cp, lv = constants.GRAV, constants.CP_AIR, constants.HLV
    assert float(precip.min()) > 0.0
    qt0, qt1 = (((q_v + q_l) * delp).sum(dim=0) / g for q_v, q_l in ((qv, ql), (qv1, ql1)))
    np.testing.assert_allclose((qt0 - qt1).numpy(), (precip * DT).numpy(), rtol=1e-9)
    h0, h1 = (((cp * tt + lv * q_v) * delp).sum(dim=0) for tt, q_v in ((t, qv), (t1, qv1)))
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-12)


@pytest.mark.parametrize("gate", ["stable", "too deep", "deep floor"])
def test_gated_columns_are_untouched(gate):
    c = _sounding("stable" if gate == "stable" else "unstable")
    if gate == "stable":
        cfg = tsas.ShallowConvectionConfig()
    elif gate == "too deep":
        cfg = tsas.ShallowConvectionConfig(**SOUNDING_FLUXES, max_depth_pa=1.0)
    else:
        cfg = tsas.DeepConvectionConfig(**SOUNDING_FLUXES, min_depth_pa=4.0e4)
    args = _t(*(c[n] for n in ARGS))
    u_dt, _, t1, qv1, _, precip = tsas.sas_step(*args, DT, cfg)
    assert torch.equal(t1, args[2]) and torch.equal(qv1, args[3])
    assert float(u_dt.abs().max()) == 0.0 and float(precip.abs().max()) == 0.0


@pytest.mark.parametrize("dt", [60.0, 1800.0, 7200.0])
def test_cfl_bounded_at_any_dt(dt):
    args = _t(*(_sounding()[n] for n in ARGS))
    cfg = tsas.ShallowConvectionConfig(sensible_heat_flux=0.3, latent_heat_flux=3e-4)
    _, _, t1, qv1, _, _ = tsas.sas_step(*args, dt, cfg)
    assert bool(torch.isfinite(t1).all())
    assert float((t1 - args[2]).abs().max()) < 15.0
    assert float(qv1.min()) >= 0.0 and float(qv1.max()) < 0.05


def test_configs_are_pace_tpu_s():
    for name in ("ShallowConvectionConfig", "DeepConvectionConfig"):
        assert ([(f.name, f.default) for f in dataclasses.fields(getattr(tsas, name))]
                == [(f.name, f.default) for f in dataclasses.fields(getattr(jsas, name))]), name
