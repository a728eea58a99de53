"""The port's Held-Suarez forcing against pace_tpu's.

``equilibrium_temperature``, ``_sigma_factor`` and ``held_suarez_step`` of
``pace_tpu_torch.models.shield.held_suarez`` against their ``pace_tpu``
namesakes (XLA, CPU) on the same numpy inputs: the D-grid winds, pt, pkz and
pressures of the baroclinic-wave state at C12 npz=8 and the grid's Coriolis
parameter, float64, at the physics timestep and at a 4-day step. Tolerance:
rtol 1e-12 with atol 1e-12 of each output's largest reference value. Then
the oracle properties of ``tests/main/test_held_suarez.py`` on the port's
side: the relaxation moves T toward T_eq and never past it, the drag acts
only below sigma_b.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import held_suarez as jhs
from pace_tpu_torch import constants
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.models.shield import held_suarez as ths

RTOL = 1e-12
N, NPZ = 12, 8


@pytest.fixture(scope="module")
def fields():
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    pe = st.pe.numpy()
    sinlat = np.clip(case.grid.f0.numpy() / (2.0 * constants.OMEGA), -1.0, 1.0)
    return dict(u=st.u.numpy(), v=st.v.numpy(), pt=st.pt.numpy(), pkz=st.pkz.numpy(),
                p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]), ps=st.ps.numpy(), f0=case.grid.f0.numpy(),
                sinlat2=(sinlat * sinlat)[:, None])


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


def test_equilibrium_temperature_and_sigma_factor_match(fields):
    f = fields
    _close(ths.equilibrium_temperature(*_t(f["p_mid"], f["sinlat2"]), ths.HeldSuarezConfig()),
           jhs.equilibrium_temperature(*_j(f["p_mid"], f["sinlat2"]), jhs.HeldSuarezConfig()))
    _close(ths._sigma_factor(*_t(f["p_mid"], f["ps"]), ths.HeldSuarezConfig()),
           jhs._sigma_factor(*_j(f["p_mid"], f["ps"]), jhs.HeldSuarezConfig()))


@pytest.mark.parametrize("dt", [225.0, 4 * 86400.0])
def test_held_suarez_step_matches(fields, dt):
    f = fields
    args = [f[k] for k in ("u", "v", "pt", "pkz", "p_mid", "ps", "f0")]
    targs = _t(*args)
    got = ths.held_suarez_step(*targs, dt, ths.HeldSuarezConfig())
    want = jhs.held_suarez_step(*_j(*args), dt, jhs.HeldSuarezConfig())
    for name, a, b in zip(("u", "v", "pt"), got, want):
        _close(a, b, name)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(targs, args))  # not written


def _column(K=20, Y=3, X=2):
    p_mid = np.broadcast_to(np.linspace(5e3, 9.9e4, K)[None, :, None, None], (1, K, Y, X))
    pkz = (p_mid / 1e5) ** constants.KAPPA
    pt = 280.0 / pkz
    return _t(np.full((1, K, Y + 1, X), 20.0), np.full((1, K, Y, X + 1), 20.0), pt, pkz, p_mid,
              np.full((1, Y, X), 1e5), np.zeros((1, Y, X)))


def test_relaxation_toward_equilibrium_and_drag_below_sigma_b():
    cfg = ths.HeldSuarezConfig()
    u, v, pt, pkz, p_mid, ps, f0 = _column()
    t0 = pt * pkz
    t_eq = ths.equilibrium_temperature(p_mid, torch.zeros_like(p_mid), cfg)
    _, _, pt1 = ths.held_suarez_step(u, v, pt, pkz, p_mid, ps, f0, 4 * 86400.0, cfg)
    t1 = pt1 * pkz
    assert bool(((t1 - t_eq).abs() <= (t0 - t_eq).abs() + 1e-9).all())
    assert float((t1 - t0).abs().max()) > 1e-3
    u1, _, _ = ths.held_suarez_step(u, v, pt, pkz, p_mid, ps, f0, 3600.0, cfg)
    for k, s in enumerate(p_mid[0, :, 0, 0].numpy() / 1e5):
        if s < cfg.sigma_b - 0.05:
            assert float(u1[0, k, 1, 0]) == 20.0
        if s > cfg.sigma_b + 0.05:
            assert float(u1[0, k, 1, 0]) < 20.0
