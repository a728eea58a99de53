"""The port's Reed-Jablonowski simple physics against pace_tpu's.

``_qsat``, ``_condense``, ``_tridiag_implicit`` and ``simple_physics_step``
of ``pace_tpu_torch.models.shield.simple_physics`` against their
``pace_tpu`` namesakes (XLA, CPU) on the same numpy inputs, float64: the
A-grid winds, temperature, vapor and pressures of the moist baroclinic-wave
state at C12 npz=8 (``demos.physics_step``'s tracer block, so that
supersaturated levels condense), and the idealized column of
``tests/main/test_simple_physics.py`` with winds either side of the 20 m/s
drag cap. Tolerance: rtol 1e-12 with atol 1e-12 of each output's largest
reference value. Then its oracle properties on the port's side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import simple_physics as jrj
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import simple_physics as trj
from pace_tpu_torch.models.shield.physics import Physics

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
ARGS = ("ua", "va", "t", "qv", "pe", "p_mid", "delp", "phis")


@pytest.fixture(scope="module")
def cols():
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    ua, va = Physics(case.grid, (), DT)._a_grid_winds(st)
    qv = st.q[:, TRACER_NAMES.index("qvapor")]
    pe = st.pe.numpy()
    return dict(ua=ua.numpy(), va=va.numpy(), qv=qv.numpy(),
                t=(st.pt * st.pkz / (1.0 + constants.ZVIR * qv)).numpy(), pe=pe,
                p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]), delp=pe[:, 1:] - pe[:, :-1],
                phis=st.phis.numpy())


def _idealized(K=12, qv0=2.0e-3):
    S, Y, X = 1, 4, 4
    pe = np.broadcast_to(np.linspace(1.0e4, 1.0e5, K + 1)[None, :, None, None], (S, K + 1, Y, X))
    t = np.broadcast_to(np.linspace(210.0, 300.0, K)[None, :, None, None], (S, K, Y, X))
    ua = np.broadcast_to(np.array([5.0, 15.0, 19.9, 25.0])[None, None, :, None], (S, K, Y, X))
    return dict(ua=ua, va=np.full((S, K, Y, X), 3.0), t=t, qv=np.full((S, K, Y, X), qv0),
                pe=pe, p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]), delp=pe[:, 1:] - pe[:, :-1],
                phis=np.zeros((S, Y, X)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def test_qsat_and_condense_match(cols):
    c = cols
    cfg_t, cfg_j = trj.SimplePhysicsConfig(), jrj.SimplePhysicsConfig()
    _close(trj._qsat(*_t(c["t"], c["p_mid"]), cfg_t), jrj._qsat(*_j(c["t"], c["p_mid"]), cfg_j))
    args = (c["t"], c["qv"], c["p_mid"], c["delp"])
    got = trj._condense(*_t(*args), DT, cfg_t)
    for name, a, b in zip(("t", "qv", "precip"), got, jrj._condense(*_j(*args), DT, cfg_j)):
        _close(a, b, name)
    assert float(got[2].max()) > 0.0  # supersaturated levels rain out


def test_tridiag_implicit_matches(cols):
    c = cols
    rng = np.random.default_rng(6)
    ka = rng.uniform(0.0, 5e3, c["delp"][:, 1:].shape)
    dp_int = c["p_mid"][:, 1:] - c["p_mid"][:, :-1]
    args = (c["t"], ka, c["delp"], dp_int)
    _close(trj._tridiag_implicit(*_t(*args), DT), jrj._tridiag_implicit(*_j(*args), DT))


@pytest.mark.parametrize("which", ["state", "idealized column"])
def test_simple_physics_step_matches(cols, which):
    c = cols if which == "state" else _idealized()
    args = [c[n] for n in ARGS]
    got = trj.simple_physics_step(*_t(*args), DT, trj.SimplePhysicsConfig())
    want = jrj.simple_physics_step(*_j(*args), DT, jrj.SimplePhysicsConfig())
    for name, a, b in zip(("u_dt", "v_dt", "t", "qv", "precip"), got, want):
        _close(a, b, f"{which} {name}")


def test_condensation_rains_and_surface_fluxes_drive_toward_the_sst():
    c = _idealized(qv0=0.01)
    args = _t(*[c[n] for n in ARGS])
    cfg = trj.SimplePhysicsConfig()
    u_dt, _, t_new, qv_new, precip = trj.simple_physics_step(*args, 600.0, cfg)
    ua, t, qv, p_mid = args[0], args[2], args[3], args[5]
    # no level is left supersaturated beyond the gamma undershoot; it rains
    assert float((qv_new - trj._qsat(t_new, p_mid, cfg)).max()) < 1e-4
    assert float(precip.min()) >= 0.0 and float(precip.max()) > 0.0
    # the drag decelerates the lowest level; the warm ocean heats it
    assert float((u_dt[:, -1] * ua[:, -1]).max()) < 0.0
    assert float((t_new[:, -1] - t[:, -1]).min()) > 0.0


def test_diffusion_conserves_the_column_integrals():
    """With no surface exchange and no condensation, the flux-form diffusion
    conserves the mass-weighted column integrals of theta and vapor."""
    c = _idealized(qv0=1.0e-5)
    ua, va, t, qv, pe, p_mid, delp, phis = _t(*[c[n] for n in ARGS])
    _, _, t_new, qv_new, _ = trj.simple_physics_step(ua, va, t, qv, pe, p_mid, delp, phis,
                                                     600.0, trj.SimplePhysicsConfig(c_hq=0.0))
    exner = (p_mid / 1.0e5) ** (2.0 / 7.0)
    np.testing.assert_allclose((t_new / exner * delp).sum(dim=-3).numpy(),
                               (t / exner * delp).sum(dim=-3).numpy(), rtol=1e-12)
    np.testing.assert_allclose((qv_new * delp).sum(dim=-3).numpy(),
                               (qv * delp).sum(dim=-3).numpy(), rtol=1e-12)
