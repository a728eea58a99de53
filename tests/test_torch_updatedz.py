"""The port's interface-height operators against pace_tpu's.

Same inputs (numpy, seeded, float64, C12 grid through
``GridData.from_numpy``) through ``pace_tpu.ops.nonhydro`` (jnp forms), the
Pallas kernels of ``updatedz_pallas`` in interpret mode, and the port's plain
PyTorch versions, which the dispatchers run on CPU tensors. Tolerance: that
of pace_tpu's own comparison of its two forms, rtol 1e-12 and atol 1e-9,
on the whole plane (the edge handling is the same pads on every side).
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
from pace_tpu.ops.updatedz_pallas import heights_from_delz_pallas, updatedz_c_pallas
from pace_tpu_torch import constants
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import nonhydro as tnh
from pace_tpu_torch.ops import updatedz_kernel

S, Y, X = 6, 18, 18
RTOL, ATOL = 1e-12, 1e-9
DT2 = 30.0


@pytest.fixture(scope="module")
def grids():
    mt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    arrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        arrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return jgrid, GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)


def _fields(K, seed):
    rng = np.random.RandomState(seed)
    delz = -(50.0 + 100.0 * rng.rand(S, K, Y, X))
    phis = 2000.0 * rng.rand(S, Y, X)
    xfx = rng.randn(S, K, Y, X + 1) * 1e5  # both signs: both upwind branches
    yfx = rng.randn(S, K, Y + 1, X) * 1e5
    return delz, phis, xfx, yfx


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("K", [11, 8])
def test_heights_from_delz_matches(K, ref):
    delz, phis, _, _ = _fields(K, seed=K)
    if ref == "jnp":
        want = jnh.heights_from_delz(jnp.asarray(delz), jnp.asarray(phis))
    else:
        want = heights_from_delz_pallas(jnp.asarray(delz), jnp.asarray(phis), interpret=True)
    got = tnh.heights_from_delz(_t(delz), _t(phis))
    assert got.shape == (S, K + 1, Y, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_heights_properties():
    """Bottom interface at the surface height, heights decreasing downward,
    layer differences give delz back; the dispatcher on CPU tensors is the
    plain version."""
    delz, phis, _, _ = _fields(5, seed=1)
    zh = tnh.heights_from_delz(_t(delz), _t(phis))
    assert torch.equal(zh, tnh.heights_from_delz_plain(_t(delz), _t(phis)))
    np.testing.assert_allclose(zh[:, -1].numpy(), phis / constants.GRAV, rtol=1e-15)
    assert bool((zh[:, :-1] > zh[:, 1:]).all())
    np.testing.assert_allclose((zh[:, 1:] - zh[:, :-1]).numpy(), delz, rtol=1e-11)


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("K", [11, 8])
@pytest.mark.parametrize("out", ["zh", "ws"])
def test_updatedz_c_matches(grids, K, ref, out):
    """K=11 leaves a partial last k-block in the Pallas kernel (9 interfaces
    are 8 + 1 for K=8)."""
    jgrid, tgrid = grids
    delz, phis, xfx, yfx = _fields(K, seed=K)
    jd, jp = jnp.asarray(delz), jnp.asarray(phis)
    zh_x = jnh.heights_from_delz(jd, jp)
    zh_y = jnh.heights_from_delz(jd * 1.01, jp)
    if ref == "jnp":
        want = jnh.updatedz_c(zh_x, zh_y, jnp.asarray(xfx), jnp.asarray(yfx), jgrid, DT2)
    else:
        want = updatedz_c_pallas(zh_x, zh_y, jnp.asarray(xfx), jnp.asarray(yfx), jgrid.area,
                                 DT2, interpret=True)
    got = tnh.updatedz_c(_t(np.asarray(zh_x)), _t(np.asarray(zh_y)), _t(xfx), _t(yfx),
                         tgrid, DT2)
    i = 0 if out == "zh" else 1
    assert got[i].shape == ((S, K + 1, Y, X) if out == "zh" else (S, Y, X))
    np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=RTOL, atol=ATOL)


def test_updatedz_c_properties(grids):
    """The bottom interface is pinned to the surface, ``ws`` is the rate of
    the advected bottom height, zero fluxes change nothing, and the
    dispatcher on CPU tensors is the plain version."""
    _jgrid, tgrid = grids
    delz, phis, xfx, yfx = _fields(6, seed=3)
    zh_x = tnh.heights_from_delz(_t(delz), _t(phis))
    zh_y = tnh.heights_from_delz(_t(delz * 1.01), _t(phis))
    zh, ws = tnh.updatedz_c(zh_x, zh_y, _t(xfx), _t(yfx), tgrid, DT2)
    pz, pw = tnh.updatedz_c_plain(zh_x, zh_y, _t(xfx), _t(yfx), tgrid.area, DT2)
    assert torch.equal(zh, pz) and torch.equal(ws, pw)
    assert torch.equal(zh[:, -1], zh_x[:, -1])
    assert float(ws.abs().max()) > 0
    z0, w0 = tnh.updatedz_c(zh_x, zh_y, _t(0 * xfx), _t(0 * yfx), tgrid, DT2)
    np.testing.assert_allclose(z0.numpy(), zh_x.numpy(), rtol=1e-14)
    assert float(w0.abs().max()) < 1e-9


def test_kernel_wrappers_reject_cpu_tensors(grids):
    """The kernel wrappers never run the plain versions: CPU input raises."""
    _jgrid, tgrid = grids
    delz, phis, xfx, yfx = (_t(a) for a in _fields(4, seed=2))
    with pytest.raises(ValueError, match="CUDA device"):
        updatedz_kernel.heights_from_delz_cuda(delz, phis)
    zh = tnh.heights_from_delz(delz, phis)
    with pytest.raises(ValueError, match="CUDA device"):
        updatedz_kernel.updatedz_c_cuda(zh, zh, xfx, yfx, tgrid.area, DT2)
