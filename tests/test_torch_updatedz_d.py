"""The port's D-grid interface-height advection (updatedz_d) against pace_tpu's.

Same inputs (numpy, seeded, float64, C12 grid through
``GridData.from_numpy``) through ``pace_tpu.ops.nonhydro.updatedz_d`` (XLA
path), the Pallas flux-update kernel of ``updatedz_pallas`` in interpret mode,
and the port's plain PyTorch versions, which the dispatchers run on CPU
tensors. Tolerance: rtol 1e-12 with atol 1e-9 m on heights of a few
kilometres (that of pace_tpu's own comparison of its two forms): the flux
update on the whole plane, ``updatedz_d`` on the compute domain (its PPM
fluxes wrap in the outer rings, which no consumer reads).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import nonhydro as jnh
from pace_tpu.ops.updatedz_pallas import flux_height_update_pallas
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import nonhydro as tnh
from pace_tpu_torch.ops import updatedz_kernel

S, Y, X = 6, 18, 18
H = 3
RTOL, ATOL = 1e-12, 1e-9
DT = 200.0 / 56
INNER = np.s_[..., H:-H, H:-H]


@pytest.fixture(scope="module")
def grids():
    mt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    arrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        arrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return jgrid, GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)


def _fields(K, seed, area):
    """Heights in both folds and layer Courant numbers and area fluxes of
    both signs, the fluxes a few percent of the cell area."""
    rng = np.random.RandomState(seed)
    delz = -(50.0 + 100.0 * rng.rand(S, K, Y, X))
    phis = 2000.0 * rng.rand(S, Y, X)
    zh_x = np.asarray(jnh.heights_from_delz(jnp.asarray(delz), jnp.asarray(phis)))
    zh_y = np.asarray(jnh.heights_from_delz(jnp.asarray(delz * 1.01), jnp.asarray(phis)))
    a = float(np.asarray(area).min())
    crx = 0.2 * rng.randn(S, K, Y, X + 1)
    cry = 0.2 * rng.randn(S, K, Y + 1, X)
    xfx = 0.05 * a * rng.randn(S, K, Y, X + 1)
    yfx = 0.05 * a * rng.randn(S, K, Y + 1, X)
    return zh_x, zh_y, crx, cry, xfx, yfx


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("K", [11, 8])
def test_flux_height_update_matches(grids, K, ref):
    """K=11 leaves a partial last k-block in the Pallas kernel."""
    jgrid, tgrid = grids
    zh, _zy, _crx, _cry, xfx, yfx = _fields(K, K, jgrid.area)
    rng = np.random.RandomState(50 + K)
    to_i = lambda f: np.asarray(tnh._to_iface(_t(f)))  # noqa: E731
    xfx_i, yfx_i = to_i(xfx), to_i(yfx)
    fx, fy = xfx_i * (3000.0 + rng.randn(*xfx_i.shape)), yfx_i * (3000.0 + rng.randn(*yfx_i.shape))
    args = (zh, fx, fy, xfx_i, yfx_i)
    if ref == "pallas":
        want = flux_height_update_pallas(*_j(*args), jgrid.area, interpret=True)
    else:  # the tail of pace_tpu's updatedz_d, written out
        a = np.asarray(jgrid.area)[:, None]
        ra = a + (xfx_i[..., :-1] - xfx_i[..., 1:]) + (yfx_i[..., :-1, :] - yfx_i[..., 1:, :])
        want = (zh * a + (fx[..., :-1] - fx[..., 1:]) + (fy[..., :-1, :] - fy[..., 1:, :])) / ra
    targs = [_t(x) for x in args]
    got = tnh.flux_height_update(*targs, tgrid.area)
    assert got.shape == (S, K + 1, Y, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tnh.flux_height_update_plain(*targs, tgrid.area))


@pytest.mark.parametrize("hord", [5, 6])
@pytest.mark.parametrize("K", [11, 8])
def test_updatedz_d_matches(grids, K, hord):
    jgrid, tgrid = grids
    f = _fields(K, 7 + K, jgrid.area)
    want = jnh.updatedz_d(*_j(*f), jgrid, DT, hord=hord)
    got = tnh.updatedz_d(*(_t(x) for x in f), tgrid, DT, hord=hord)
    assert got.shape == (S, K + 1, Y, X)
    np.testing.assert_allclose(got.numpy()[INNER], np.asarray(want)[INNER], rtol=RTOL,
                               atol=ATOL)


def test_updatedz_d_default_hord_is_5(grids):
    jgrid, tgrid = grids
    f = [_t(x) for x in _fields(5, 3, jgrid.area)]
    assert torch.equal(tnh.updatedz_d(*f, tgrid, DT), tnh.updatedz_d(*f, tgrid, DT, hord=5))


def test_updatedz_d_properties(grids):
    """Zero fluxes change nothing; a uniform height stays uniform under any
    fluxes (the flux form divides by the updated area)."""
    jgrid, tgrid = grids
    zh_x, zh_y, crx, cry, xfx, yfx = (_t(x) for x in _fields(6, 4, jgrid.area))
    zero = tnh.updatedz_d(zh_x, zh_y, 0 * crx, 0 * cry, 0 * xfx, 0 * yfx, tgrid, DT)
    np.testing.assert_allclose(zero.numpy(), zh_x.numpy(), rtol=1e-14)
    flat = torch.full_like(zh_x, 1234.5)
    out = tnh.updatedz_d(flat, flat, crx, cry, xfx, yfx, tgrid, DT)
    np.testing.assert_allclose(out.numpy()[INNER], 1234.5, rtol=1e-13)


def test_to_iface():
    f = torch.arange(4.0).reshape(1, 4, 1, 1)
    assert tnh._to_iface(f).flatten().tolist() == [0.0, 0.5, 1.5, 2.5, 3.0]


def test_flux_height_update_kernel_rejects_cpu_tensors(grids):
    """The kernel wrapper never runs the plain version: CPU input raises."""
    jgrid, tgrid = grids
    zh, _zy, _crx, _cry, xfx, yfx = (_t(x) for x in _fields(4, 2, jgrid.area))
    xfx_i, yfx_i = tnh._to_iface(xfx), tnh._to_iface(yfx)
    with pytest.raises(ValueError, match="CUDA device"):
        updatedz_kernel.flux_height_update_cuda(zh, xfx_i, yfx_i, xfx_i, yfx_i, tgrid.area)
    with pytest.raises(ValueError, match=r"takes \(S, K\+1, Y, X\) heights"):
        updatedz_kernel.flux_height_update_cuda(zh[0], xfx_i, yfx_i, xfx_i, yfx_i, tgrid.area)
    assert updatedz_kernel.LAUNCHES["flux_height_update"] == 0
