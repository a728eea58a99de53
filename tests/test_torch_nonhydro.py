"""The port's semi-implicit vertical solvers against pace_tpu's.

Same inputs (numpy, seeded, float64) through ``pace_tpu.ops.nonhydro`` (the
``lax.scan`` formulation), the Pallas column kernel in interpret mode, and
the port's plain PyTorch versions. Tolerances: rtol 1e-12 against the scan
formulation, with atol 1e-12 of the largest reference value (the columns are
far from balance, so some ``w`` are small differences of large terms; XLA
contracts multiply-adds on the CPU) and, for ``pp``, a cancelling difference
of pressures near 1e5 Pa, 1e-9 of the largest interface pressure; against the
Pallas kernel the tolerance of pace_tpu's own test (rtol 1e-7; ``pp`` rtol 1e-6, atol 1e-6).
The physical cases of pace_tpu's ``test_nonhydro.py`` follow, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import nonhydro as jnh
from pace_tpu.ops.sim1_pallas import sim1_solver_pallas
from pace_tpu_torch import constants
from pace_tpu_torch.ops import nonhydro as tnh
from pace_tpu_torch.ops import sim1_kernel

RTOL = 1e-12
NAMES = ("w", "delz", "pp")


def _columns(S=2, K=7, Y=6, X=9, seed=0):
    """Hydrostatically plausible columns: delp > 0, delz < 0, pt ~ 300 K."""
    rng = np.random.RandomState(seed)
    delp = 50.0 + 100.0 * rng.rand(S, K, Y, X)
    pt = 270.0 + 40.0 * rng.rand(S, K, Y, X)
    pkz = 0.3 + 0.5 * rng.rand(S, K, Y, X)
    delz = -(20.0 + 400.0 * rng.rand(S, K, Y, X))
    w = 2.0 * rng.randn(S, K, Y, X)
    ws = 0.5 * rng.randn(S, Y, X)
    return w, delz, pt, delp, pkz, ws


def _balanced_column(K=25, Y=2, X=2, ptop=100.0):
    """Hydrostatically balanced isothermal column."""
    pe = np.linspace(ptop, 1e5, K + 1)[None, :, None, None] * np.ones((1, 1, Y, X))
    delp = np.diff(pe, axis=1)
    peln = np.log(pe)
    pk = (pe / constants.P_REF) ** constants.KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (constants.KAPPA * np.diff(peln, axis=1))
    t = np.full_like(delp, 260.0)
    pt = t / pkz
    delz = -constants.RDGAS / constants.GRAV * t * np.diff(peln, axis=1)
    return tuple(torch.from_numpy(a) for a in
                 (np.zeros_like(delp), delz, pt, delp, pkz, np.zeros((1, Y, X))))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_triplet(got, want, rtol, pp_rtol, pp_atol, label):
    for name, g, r in zip(NAMES, got, want):
        r = np.asarray(r)
        assert g.shape == r.shape
        if name == "pp":
            np.testing.assert_allclose(g.numpy(), r, rtol=pp_rtol, atol=pp_atol,
                                       err_msg=f"{name} {label}")
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=rtol * np.abs(r).max(),
                                       err_msg=f"{name} {label}")


def test_gamma_matches():
    assert tnh.GAMMA == jnh.GAMMA


def test_tridiagonal_solve_matches_and_solves():
    rng = np.random.RandomState(0)
    K, Y, X = 12, 3, 2
    a = rng.rand(1, K, Y, X) * 0.3
    c = rng.rand(1, K, Y, X) * 0.3
    b = 1.0 + a + c  # diagonally dominant
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    x_true = rng.rand(1, K, Y, X)
    d = b * x_true
    d[:, 1:] += a[:, 1:] * x_true[:, :-1]
    d[:, :-1] += c[:, :-1] * x_true[:, 1:]
    got = tnh.tridiagonal_solve(*_t((a, b, c, d))).numpy()
    ref = np.asarray(jnh.tridiagonal_solve(*_j((a, b, c, d))))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, x_true, rtol=1e-10)


def test_interface_mass_weighted_matches():
    w, _delz, _pt, delp, _pkz, _ws = _columns(seed=3)
    got = tnh._interface_mass_weighted(*_t((delp, w))).numpy()
    ref = np.asarray(jnh._interface_mass_weighted(*_j((delp, w))))
    assert got.shape == (2, 6, 6, 9)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("a_imp", [1.0, 0.75, 0.5])
def test_sim1_solver_matches_scan(a_imp):
    cols = _columns(seed=1)
    dt, ptop = 4.0, 300.0
    ref = jnh.sim1_solver(*_j(cols), dt, ptop, a_imp=a_imp)
    got = tnh.sim1_solver(*_t(cols), dt, ptop, a_imp=a_imp)
    pe_max = ptop + cols[3].sum(axis=1).max()
    _assert_triplet(got, ref, RTOL, RTOL, 1e-9 * pe_max, f"a_imp={a_imp}")


@pytest.mark.parametrize("shape", [(2, 7, 6, 9), (1, 6, 11, 150)], ids=["small", "ragged"])
def test_sim1_solver_matches_pallas(shape):
    """Against the Pallas column kernel in interpret mode, at the tolerance
    of pace_tpu's own comparison of its two formulations; the second plane
    size is not a multiple of the kernel's (8, 128) block."""
    cols = _columns(*shape, seed=2)
    dt, ptop = 2.0, 100.0
    ref = sim1_solver_pallas(*_j(cols), dt, ptop, interpret=True)
    got = tnh.sim1_solver(*_t(cols), dt, ptop)
    _assert_triplet(got, ref, 1e-7, 1e-6, 1e-6, "vs pallas")


def test_p_fac_floor_matches():
    w, delz, pt, delp, pkz, _ws = _columns(seed=4)
    dz_new = delz * (1.0 + 40.0 * np.random.RandomState(5).rand(*delz.shape))
    ref = np.asarray(jnh._p_fac_floor(*_j((dz_new, pt, delp, pkz)), 300.0, 0.05))
    got = tnh._p_fac_floor(*_t((dz_new, pt, delp, pkz)), 300.0, 0.05).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    changed = got != dz_new
    assert changed.any() and not changed.all()  # the floor binds in places


@pytest.mark.parametrize("a_imp,p_fac", [(1.0, 0.05), (1.0, 2.0), (0.75, 0.05)],
                         ids=["default", "floor-binds", "blend"])
def test_sim1_solver_best_matches(a_imp, p_fac):
    """The dispatcher on CPU tensors (plain solve + floor) against
    pace_tpu's, and for ``a_imp == 1`` against the Pallas kernel with its
    in-kernel floor."""
    cols = _columns(seed=6)
    dt, ptop = 4.0, 300.0
    ref = jnh.sim1_solver_best(*_j(cols), dt, ptop, a_imp=a_imp, p_fac=p_fac)
    got = tnh.sim1_solver_best(*_t(cols), dt, ptop, a_imp=a_imp, p_fac=p_fac)
    pe_max = ptop + cols[3].sum(axis=1).max()
    _assert_triplet(got, ref, RTOL, RTOL, 1e-9 * pe_max, "vs scan")
    if a_imp == 1.0:
        pal = sim1_solver_pallas(*_j(cols), dt, ptop, p_fac=p_fac, interpret=True)
        _assert_triplet(got, pal, 1e-7, 1e-6, 1e-6, "vs pallas")
    if p_fac > 1.0:  # these columns' gas-law pressure is a few times the hydrostatic
        bound = got[1] > tnh.sim1_solver(*_t(cols), dt, ptop, a_imp=a_imp)[1]
        assert bound.any() and not bound.all()  # the floor binds in places


def test_sim1_solver_best_skips_floor_without_p_fac():
    cols = _t(_columns(seed=6))
    got = tnh.sim1_solver_best(*cols, 4.0, 300.0, p_fac=0.0)
    want = tnh.sim1_solver(*cols, 4.0, 300.0)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("a_imp", [0.75, 0.5])
def test_sim1_solver_best_kernel_route_refuses_blend(monkeypatch, a_imp):
    """On the kernel route (CUDA tensors) the θ-blend goes to the kernel
    with its ``a_imp`` and never to the plain version: the blend has its
    own instantiation of the kernel (the kernel refused it until then)."""
    launched = []
    monkeypatch.setattr(tnh, "route", lambda *ts: "kernel")
    monkeypatch.setattr(tnh, "sim1_solver_cuda", lambda *a, **k: launched.append(k) or "k")
    monkeypatch.setattr(tnh, "sim1_solver", lambda *a, **k: launched.append("plain"))
    assert tnh.sim1_solver_best(*_t(_columns(seed=6)), 4.0, 300.0, a_imp=a_imp,
                                p_fac=0.05) == "k"
    assert launched == [{"p_fac": 0.05, "a_imp": a_imp}]


@pytest.mark.parametrize("solver", ["riem_solver_c", "riem_solver3"])
def test_riem_solvers_match(solver):
    cols = _columns(seed=7)
    dt, ptop = 1.7857, 300.0
    ref = getattr(jnh, solver)(*_j(cols), dt, ptop, a_imp=1.0, p_fac=0.05)
    got = getattr(tnh, solver)(*_t(cols), dt, ptop, a_imp=1.0, p_fac=0.05)
    assert len(got) == len(ref) == (2 if solver == "riem_solver_c" else 3)
    pe_max = ptop + cols[3].sum(axis=1).max()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        atol = 1e-9 * pe_max if g.shape[1] == r.shape[1] == cols[0].shape[1] + 1 else 0
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=atol, err_msg=solver)
    if solver == "riem_solver_c":
        assert torch.equal(got[0][:, 0], torch.full_like(got[0][:, 0], ptop))  # pp[0] = 0


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU input raises."""
    cols = _t(_columns())
    with pytest.raises(ValueError, match="CUDA device"):
        sim1_kernel.sim1_solver_cuda(*cols, 4.0, 300.0, p_fac=0.05)
    with pytest.raises(ValueError, match="at least two layers"):
        sim1_kernel.sim1_solver_cuda(*(c[:, :1] for c in cols[:5]), cols[5], 4.0, 300.0)


# --- the physical cases of pace_tpu's test_nonhydro.py, on the port


@pytest.mark.parametrize("a_imp", [0.5, 0.75, 1.0])
def test_balanced_column_stays_at_rest(a_imp):
    """Equilibrium is a fixed point of the blended scheme for every
    implicitness weight."""
    w, delz, pt, delp, pkz, ws = _balanced_column()
    w2, delz2, pp = tnh.sim1_solver(w, delz, pt, delp, pkz, ws, dt=10.0, ptop=100.0,
                                    a_imp=a_imp)
    assert float(pp.abs().max()) < 50.0
    assert float(w2.abs().max()) < 0.6
    assert float(((delz2 - delz) / delz).abs().max()) < 5e-3


def test_compression_raises_pressure():
    """A column squeezed from below (ws > 0) develops positive perturbation
    pressure near the surface and upward acceleration."""
    w, delz, pt, delp, pkz, ws = _balanced_column()
    w2, _delz2, pp = tnh.sim1_solver(w, delz, pt, delp, pkz, ws + 1.0, dt=10.0, ptop=100.0)
    assert float(pp[:, -1].mean()) > 0.0
    assert float(w2[:, -1].mean()) > 0.0


def test_a_imp_damping_ordering():
    """Backward Euler damps an acoustic transient fastest, the trapezoidal
    limit keeps most of it: kinetic energy after several steps is monotone
    in the implicitness weight."""
    amps = {}
    for a_imp in (0.5, 0.75, 1.0):
        w, delz, pt, delp, pkz, ws = _balanced_column(K=30)
        w = w.clone()
        w[:, 12:18] = 1.0
        for _ in range(6):
            w, delz, _pp = tnh.sim1_solver(w, delz, pt, delp, pkz, ws, dt=4.0, ptop=100.0,
                                           a_imp=a_imp)
        amps[a_imp] = float((w * w).sum())
    assert amps[0.5] > amps[0.75] > amps[1.0] > 0.0


def test_p_fac_floor_caps_expansion():
    """A layer may not expand past the thickness at which its gas-law
    pressure falls below p_fac times the hydrostatic one; thicknesses inside
    the bound pass untouched, and the dispatched solver applies the floor."""
    w, delz, pt, delp, pkz, ws = _balanced_column(K=10)
    floored = tnh._p_fac_floor(delz * 100.0, pt, delp, pkz, 100.0, 0.05)
    np.testing.assert_allclose(floored.numpy(), delz.numpy() / 0.05, rtol=1e-9)
    dz_ok = delz * 1.02
    assert torch.equal(tnh._p_fac_floor(dz_ok, pt, delp, pkz, 100.0, 0.05), dz_ok)
    _w2, dz2, _pp = tnh.sim1_solver_best(w, delz, pt, delp, pkz, ws, dt=10.0, ptop=100.0,
                                         p_fac=1.001)
    assert bool((dz2 >= delz / 1.0005).all())
