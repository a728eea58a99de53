"""The port's EDMF PBL and the shared mass-flux helpers against pace_tpu's.

``_tridiag_solve``, ``_diffusivities``, ``_mass_flux_tendencies`` and
``pbl_step`` of ``pace_tpu_torch.models.shield.pbl``, and
``hydrostatic_heights`` and ``flux_form_divergence`` of ``mf_common``,
against their ``pace_tpu`` namesakes (XLA, CPU) on the same numpy inputs:
the A-grid winds, temperature and vapor of the baroclinic-wave state at C12
npz=8 with the tracer block of ``demos.physics_step.moist_tracers``,
float64; ``pbl_step`` with zero surface fluxes (``bench.py``'s physics) and
with positive ones, under which the mass-flux plume is active, and on the
idealized soundings of ``tests/main/test_pbl.py``. Tolerance: rtol 1e-12
with atol 1e-12 of each output's largest reference value. Then the oracle
properties of ``tests/main/test_pbl.py`` on the port's side: the Thomas
solve against a dense solve, column conservation of the diffusion and of
the mass flux, and the surface drag.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.models.shield import mf_common as jmf
from pace_tpu.models.shield import pbl as jpbl
from pace_tpu_torch import constants
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.demos import dycore_step as ddemo
from pace_tpu_torch.demos import physics_step as pdemo
from pace_tpu_torch.models.shield import mf_common as tmf
from pace_tpu_torch.models.shield import pbl as tpbl
from pace_tpu_torch.models.shield.physics import Physics

RTOL = 1e-12
N, NPZ = 12, 8
DT = 200.0
FLUXES = dict(sensible_heat_flux=0.15, latent_heat_flux=1e-4)


@pytest.fixture(scope="module")
def cols():
    """Numpy inputs of pbl_step from the moist baroclinic-wave state."""
    case = ddemo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    st = case.state
    st.q = torch.from_numpy(pdemo.moist_tracers(st, seed=0))
    ua, va = Physics(case.grid, (), DT)._a_grid_winds(st)
    qv = st.q[:, TRACER_NAMES.index("qvapor")]
    pe = st.pe.numpy()
    return dict(
        ua=ua.numpy(), va=va.numpy(),
        t=(st.pt * st.pkz / (1.0 + constants.ZVIR * qv)).numpy(), qv=qv.numpy(), pe=pe,
        p_mid=0.5 * (pe[:, 1:] + pe[:, :-1]), delp=st.delp.numpy(), zs=st.phis.numpy(),
    )


def _sounding(K=24, unstable=False):
    """tests/main/test_pbl.py's idealized sounding, (1, K, 2, 2) columns."""
    S, Y, X = 1, 2, 2
    ps = 1.0e5
    pe = np.linspace(2000.0, ps, K + 1)
    pe = np.broadcast_to(pe[None, :, None, None], (S, K + 1, Y, X)).copy()
    p_mid = 0.5 * (pe[:, 1:] + pe[:, :-1])
    delp = pe[:, 1:] - pe[:, :-1]
    theta = 290.0 + 60.0 * (1.0 - p_mid / ps)
    if unstable:
        theta = theta[..., ::-1, :, :].copy()
    t = theta * (p_mid / 1.0e5) ** 0.2859
    return dict(ua=10.0 * (1.0 - p_mid / ps) + 5.0, va=np.zeros_like(t), t=t,
                qv=np.full_like(t, 5e-3), pe=pe, p_mid=p_mid, delp=delp,
                zs=np.zeros((S, Y, X)))


ARGS = ("ua", "va", "t", "qv", "pe", "p_mid", "delp", "zs")


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


def _system(seed=0, shape=(1, 12, 2, 3)):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.4, -0.1, shape)
    up = rng.uniform(-0.4, -0.1, shape)
    lo[:, 0] = 0.0
    up[:, -1] = 0.0
    return lo, 1.0 - lo - up, up, rng.standard_normal(shape)


def test_tridiag_solve_matches_and_solves():
    lo, di, up, rhs = _system()
    got = tpbl._tridiag_solve(*_t(lo, di, up, rhs))
    _close(got, jpbl._tridiag_solve(*_j(lo, di, up, rhs)))
    x = got.numpy()
    for j in range(2):
        for i in range(3):
            m = (np.diag(di[0, :, j, i]) + np.diag(lo[0, 1:, j, i], -1)
                 + np.diag(up[0, :-1, j, i], 1))
            np.testing.assert_allclose(x[0, :, j, i], np.linalg.solve(m, rhs[0, :, j, i]),
                                       rtol=1e-12)


def test_hydrostatic_heights_match(cols):
    tv = cols["t"] * (1.0 + constants.ZVIR * cols["qv"])
    for name, a, b in zip(("z_mid", "z_if", "dz"), tmf.hydrostatic_heights(*_t(tv, cols["pe"])),
                          jmf.hydrostatic_heights(*_j(tv, cols["pe"]))):
        _close(a, b, name)


def test_flux_form_divergence_matches(cols):
    rng = np.random.default_rng(3)
    shape = cols["delp"].shape
    m_if = rng.random((shape[0], shape[1] + 1) + shape[2:])
    m_if[:, 0] = m_if[:, -1] = 0.0
    x_u, x_env = rng.random(shape), rng.random(shape)
    args = (m_if, x_u, x_env, cols["delp"])
    _close(tmf.flux_form_divergence(*_t(*args)), jmf.flux_form_divergence(*_j(*args)))


def _intermediates(c):
    """The inputs of _diffusivities and _mass_flux_tendencies, from pace_tpu
    as numpy."""
    tv = c["t"] * (1.0 + constants.ZVIR * c["qv"])
    z_mid, z_if, dz = (np.asarray(a) for a in jmf.hydrostatic_heights(*_j(tv, c["pe"])))
    thv = tv * (constants.P_REF / c["p_mid"]) ** constants.KAPPA
    return tv, z_mid, z_if, dz, thv


@pytest.mark.parametrize("which", ["state", "stable sounding", "unstable sounding"])
def test_diffusivities_match(cols, which):
    c = cols if which == "state" else _sounding(unstable=which.startswith("unstable"))
    tv, z_mid, z_if, dz, thv = _intermediates(c)
    args = (c["ua"], c["va"], thv, z_mid, z_if)
    got = tpbl._diffusivities(*_t(*args), tpbl.PBLConfig())
    want = jpbl._diffusivities(*_j(*args), jpbl.PBLConfig())
    for name, a, b in zip(("k_m", "ustar", "cd", "spd1", "h"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("fluxes", ["zero", "positive"])
def test_mass_flux_tendencies_match(cols, fluxes):
    c = cols
    kw = FLUXES if fluxes == "positive" else dict(sensible_heat_flux=0.0, latent_heat_flux=0.0)
    shf, lhf = kw["sensible_heat_flux"], kw["latent_heat_flux"]
    tv, z_mid, z_if, dz, thv = _intermediates(c)
    h = np.asarray(jpbl._diffusivities(*_j(c["ua"], c["va"], thv, z_mid, z_if),
                                       jpbl.PBLConfig())[4])
    s = constants.CP_AIR * c["t"] + constants.GRAV * z_mid
    wthv = shf * (1.0 + constants.ZVIR * c["qv"][:, -1]) + constants.ZVIR * c["t"][:, -1] * lhf
    wstar = np.cbrt(np.maximum(constants.GRAV / thv[:, -1] * wthv * np.maximum(h, 1.0), 0.0))
    arrays = (s, c["qv"], thv, tv, z_mid, dz, c["p_mid"], c["delp"], h, wstar, wthv)
    got = tpbl._mass_flux_tendencies(*_t(*arrays), shf, lhf, DT, tpbl.PBLConfig(**kw))
    want = jpbl._mass_flux_tendencies(*_j(*arrays), shf, lhf, DT, jpbl.PBLConfig(**kw))
    for name, a, b in zip(("ds", "dq"), got, want):
        _close(a, b, name)
    if fluxes == "positive":
        # the plume is active: the tendencies move s and vapor
        assert float(got[0].abs().max()) > 0.0 and float(got[1].abs().max()) > 0.0
    else:
        assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["zero fluxes", "positive fluxes", "no mass flux",
                                  "flux arrays", "unstable sounding"])
def test_pbl_step_matches(cols, case):
    c, kw, arr = cols, {}, {}
    if case == "positive fluxes":
        kw = FLUXES
    elif case == "no mass flux":
        kw = dict(FLUXES, mass_flux=False)
    elif case == "unstable sounding":
        c, kw = _sounding(unstable=True), FLUXES
    elif case == "flux arrays":
        rng = np.random.default_rng(4)
        arr = dict(sensible_heat_flux=rng.uniform(0.0, 0.2, c["zs"].shape),
                   latent_heat_flux=rng.uniform(0.0, 2e-4, c["zs"].shape))
    args = [c[n] for n in ARGS]
    got = tpbl.pbl_step(*_t(*args), DT, tpbl.PBLConfig(**kw),
                        **{k: torch.from_numpy(v) for k, v in arr.items()})
    want = jpbl.pbl_step(*_j(*args), DT, jpbl.PBLConfig(**kw),
                         **{k: jnp.asarray(v) for k, v in arr.items()})
    for name, a, b in zip(("u_dt", "v_dt", "t", "qv", "h"), got, want):
        _close(a, b, f"{case} {name}")


# ----------------------------------------------------------------------
# oracle properties on the port's side
# ----------------------------------------------------------------------

def test_zero_surface_flux_conserves_the_column(cols):
    """Diffusion with zero-flux boundaries conserves the column vapor and
    dry static energy; the surface drag slows the winds."""
    args = _t(*(cols[n] for n in ARGS))
    ua, va, t, qv, pe, p_mid, delp, zs = args
    u_dt, v_dt, t_new, qv_new, h = tpbl.pbl_step(*args, DT, tpbl.PBLConfig())
    np.testing.assert_allclose((qv_new * delp).sum(dim=1).numpy(),
                               (qv * delp).sum(dim=1).numpy(), rtol=1e-12)
    tv = t * (1.0 + constants.ZVIR * qv)
    z_mid = tmf.hydrostatic_heights(tv, pe)[0]
    s0 = ((constants.CP_AIR * t + constants.GRAV * z_mid) * delp).sum(dim=1)
    s1 = ((constants.CP_AIR * t_new + constants.GRAV * z_mid) * delp).sum(dim=1)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-12)
    assert float(h.min()) >= 0.0
    ke0 = ((ua ** 2 + va ** 2) * delp).sum()
    ke1 = (((ua + DT * u_dt) ** 2 + (va + DT * v_dt) ** 2) * delp).sum()
    assert float(ke1) < float(ke0)


def test_mass_flux_conserves_and_transports():
    """The mass flux moves heat non-locally but leaves the column enthalpy as
    pure diffusion leaves it (flux form, M = 0 at both ends)."""
    args = _t(*(_sounding(unstable=True)[n] for n in ARGS))
    on = tpbl.pbl_step(*args, 600.0, tpbl.PBLConfig(**FLUXES))
    off = tpbl.pbl_step(*args, 600.0, tpbl.PBLConfig(**FLUXES, mass_flux=False))
    delp = args[6]

    def col(tt, qq):
        return ((constants.CP_AIR * tt + constants.HLV * qq) * delp).sum(dim=-3)

    assert float((on[2] - off[2]).abs().max()) > 1e-4
    np.testing.assert_allclose(col(on[2], on[3]).numpy(), col(off[2], off[3]).numpy(),
                               rtol=1e-12)
    assert float((on[2] - off[2])[..., :-2, :, :].max()) > 0.0


def test_mass_flux_inactive_without_surface_buoyancy_flux():
    args = _t(*(_sounding()[n] for n in ARGS))
    on = tpbl.pbl_step(*args, 600.0, tpbl.PBLConfig(mass_flux=True))
    off = tpbl.pbl_step(*args, 600.0, tpbl.PBLConfig(mass_flux=False))
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_pbl_step_leaves_its_inputs_alone(cols):
    args = _t(*(cols[n] for n in ARGS))
    before = [a.clone() for a in args]
    tpbl.pbl_step(*args, DT, tpbl.PBLConfig(**FLUXES))
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_config_is_pace_tpu_s():
    assert ([(f.name, f.default) for f in dataclasses.fields(tpbl.PBLConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jpbl.PBLConfig)])
