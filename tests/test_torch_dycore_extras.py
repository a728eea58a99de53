"""The port's dycore auxiliary operators and moist heat capacities against
pace_tpu's.

``ray_fast`` (with and without ``w``, on a full pressure field and on the
static reference profile that ``rf_fast`` uses), ``fillz``, ``neg_adj3``
(with and without latent heating), ``del2cubed``, ``apply_sponge`` and the
``moist_cv`` functions of ``pace_tpu_torch`` against ``pace_tpu``'s, on numpy
inputs made from a seed, C12, float64. Tolerance: rtol 1e-12 with atol 1e-12
of the largest reference value.
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
from pace_tpu.ops import dycore_extras as jx
from pace_tpu.ops import moist_cv as jmcv
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import dycore_extras as tx
from pace_tpu_torch.ops import moist_cv as tmcv

RTOL = 1e-12
N, K, NQ = 12, 8, 9
Y = X = N + 6


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def grids():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=K, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    arrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        arrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return jgrid, GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)


def _winds(seed=0):
    rng = np.random.RandomState(seed)
    return (20.0 * rng.randn(6, K, Y + 1, X), 20.0 * rng.randn(6, K, Y, X + 1),
            rng.randn(6, K, Y, X))


@pytest.mark.parametrize("with_w", [True, False])
def test_ray_fast_matches(with_w):
    u, v, w = _winds()
    rng = np.random.RandomState(1)
    # layer pressures from the model top through rf_cutoff to the surface
    pe_mid = np.sort(np.exp(rng.uniform(np.log(50.0), np.log(1e5), (6, K, Y, X))), axis=1)
    args = dict(dt=3.5, ptop=100.0, rf_cutoff=3000.0, tau=10.0)
    want = jx.ray_fast(*_j(u, v), jnp.asarray(w) if with_w else None, jnp.asarray(pe_mid), **args)
    tu, tv, tw, tp = _t(u, v, w, pe_mid)
    got = tx.ray_fast(tu, tv, tw if with_w else None, tp, **args)
    for name, a, b in zip("uvw", got, want):
        if b is None:
            assert a is None
            continue
        _close(a, b, name)
    assert not torch.equal(got[0], tu)  # the top layers are damped


def test_ray_fast_on_the_static_reference_profile(grids):
    """rf_fast's form: the (K,) reference profile broadcast to the layers."""
    jgrid, tgrid = grids
    u, v, w = _winds(seed=2)
    pe_ref = np.asarray(jgrid.ak) + np.asarray(jgrid.bk) * jconstants.P_REF
    pmid = 0.5 * (pe_ref[1:] + pe_ref[:-1])
    args = dict(dt=3.5, ptop=float(jgrid.ptop), rf_cutoff=3000.0, tau=10.0)
    want = jx.ray_fast(*_j(u, v, w), jnp.broadcast_to(jnp.asarray(pmid)[:, None, None], (K, Y, X)),
                       **args)
    tp = torch.from_numpy(pmid)[:, None, None].expand(K, Y, X)
    got = tx.ray_fast(*_t(u, v, w), tp, **args)
    for name, a, b in zip("uvw", got, want):
        _close(a, b, name)


def test_ray_fast_without_tau_returns_the_winds():
    tu, tv, tw = _t(*_winds())
    assert tx.ray_fast(tu, tv, tw, tw, 3.5, 100.0, 3000.0, 0.0) == (tu, tv, tw)


def _tracers(seed=3):
    """A tracer block with negative values in every species and column."""
    rng = np.random.RandomState(seed)
    q = 1e-3 * rng.rand(6, NQ, K, Y, X) - 2e-4
    delp = 100.0 + 50.0 * rng.rand(6, K, Y, X)
    return q, delp


def test_fillz_matches():
    q, delp = _tracers()
    want = jx.fillz(jnp.asarray(q), jnp.asarray(delp)[:, None])
    tq, td = _t(q, delp)
    _close(tx.fillz(tq, td[:, None]), want, "fillz")


def test_fillz_conserves_columns_that_can_fill():
    q, delp = _tracers(seed=4)
    q = q + 3e-4  # every column positive in total
    out = tx.fillz(*_t(q, delp[:, None])).numpy()
    assert out.min() >= 0.0
    before = (q * delp[:, None]).sum(axis=2)
    after = (out * delp[:, None]).sum(axis=2)
    np.testing.assert_allclose(after, before, rtol=1e-12)


@pytest.mark.parametrize("heating", [True, False])
def test_neg_adj3_matches(heating):
    q, delp = _tracers(seed=5)
    rng = np.random.RandomState(6)
    pt = 280.0 + 30.0 * rng.rand(6, K, Y, X)
    pkz = 0.5 + 0.5 * rng.rand(6, K, Y, X)
    kw = lambda a, b: dict(pt=a, pkz=b) if heating else {}  # noqa: E731
    want_q, want_pt = jx.neg_adj3(*_j(q, delp), **kw(*_j(pt, pkz)), nwat=6)
    got_q, got_pt = tx.neg_adj3(*_t(q, delp), **kw(*_t(pt, pkz)), nwat=6)
    _close(got_q, want_q, "q")
    if heating:
        _close(got_pt, want_pt, "pt")
    else:
        assert got_pt is None and want_pt is None


def test_del2cubed_and_sponge_match(grids):
    jgrid, tgrid = grids
    rng = np.random.RandomState(7)
    pt = 280.0 + 30.0 * rng.rand(6, K, Y, X)
    _close(tx.del2cubed(torch.from_numpy(pt), tgrid, 2, 0.05 * tgrid.da_min),
           jx.del2cubed(jnp.asarray(pt), jgrid, 2, 0.05 * jgrid.da_min), "del2cubed")
    for n_sponge, d_ext in ((3, 0.02), (3, 0.0), (0, 0.02)):
        want = jx.apply_sponge(jnp.asarray(pt), None, jgrid, n_sponge, d_ext, 25.0)
        got = tx.apply_sponge(torch.from_numpy(pt), None, tgrid, n_sponge, d_ext, 25.0)
        _close(got, want, f"sponge {n_sponge} {d_ext}")


@pytest.mark.parametrize("nwat", [0, 1, 2, 3, 6])
def test_moist_cv_matches(nwat):
    q = np.random.RandomState(8).rand(2, NQ, 3, 4, 5) * 1e-2
    for name in ("moist_cv", "moist_cp"):
        want = getattr(jmcv, name)(jnp.asarray(q), nwat)
        got = getattr(tmcv, name)(torch.from_numpy(q), nwat)
        for a, b in zip(got, want):
            _close(a, b, f"{name} nwat={nwat}")
    _close(tmcv.compute_q_con(torch.from_numpy(q), nwat), jmcv.compute_q_con(jnp.asarray(q), nwat))
