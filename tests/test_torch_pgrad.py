"""The port's D-grid pressure gradients against pace_tpu's.

``a2b_ord4`` (with and without the grid's tile-edge and cube-corner
treatment), the hydrostatic ``one_grad_p`` and the nonhydrostatic
``nh_p_grad`` of ``pace_tpu_torch`` against ``pace_tpu``'s XLA functions and
against ``nh_p_grad_pallas(..., interpret=True)``, on numpy inputs made from
a seed, C12, float64, the fields of ``tests/main/test_pgrad_pallas.py``
(K=11, which leaves a partial layer block in the Pallas kernel). Tolerance:
rtol 1e-12 with atol 1e-12 of the largest reference value, on the whole
plane (both sides make the same pads and rolls).
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
from pace_tpu.ops import pgrad as jpgrad
from pace_tpu.ops.pgrad_pallas import nh_p_grad_pallas
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import nonhydro, pgrad, pgrad_kernel

RTOL = 1e-12
N, K = 12, 11


def grid_arrays(jgrid):
    """A pace_tpu GridData as the numpy dict ``GridData.from_numpy`` takes."""
    out = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        out[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def grids():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=K, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    return jgrid, GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float64)


def _fields(K=K, Y=N + 6, X=N + 6, seed=0):
    """The inputs of tests/main/test_pgrad_pallas.py."""
    rng = np.random.RandomState(seed)
    S = 6
    pk = np.cumsum(0.01 + rng.rand(S, K + 1, Y, X), axis=1)
    gz = np.cumsum(0.01 + rng.rand(S, K + 1, Y, X), axis=1)[:, ::-1] * 9.8
    pp = rng.rand(S, K + 1, Y, X)
    delp = 1.0 + rng.rand(S, K, Y, X)
    u = rng.rand(S, K, Y + 1, X)
    v = rng.rand(S, K, Y, X + 1)
    return [np.ascontiguousarray(a) for a in (pk, gz, pp, delp, u, v)]


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("with_grid", [True, False])
def test_a2b_ord4_matches(grids, with_grid):
    jgrid, tgrid = grids
    q = _fields(seed=1)[0]
    want = jpgrad.a2b_ord4(jnp.asarray(q), jgrid if with_grid else None)
    got = pgrad.a2b_ord4(torch.from_numpy(q), tgrid if with_grid else None)
    _close(got, want, "a2b_ord4")


def test_a2b_ord4_blends_the_tile_edges_and_corners(grids):
    """The grid's corrections change the edge lines and the cube corners and
    nothing else."""
    _jgrid, tgrid = grids
    q = torch.from_numpy(_fields(seed=2)[1])
    plain = pgrad.a2b_ord4(q, None)
    full = pgrad.a2b_ord4(q, tgrid)
    h = tgrid.n_halo
    inner = (..., slice(h + 2, -h - 2), slice(h + 2, -h - 2))
    assert torch.equal(plain[inner], full[inner])
    assert not torch.equal(plain[..., h, :], full[..., h, :])
    jj, ii = tgrid.corner_table[0][1:3]
    assert not torch.equal(plain[..., jj, ii], full[..., jj, ii])


def test_one_grad_p_matches(grids):
    jgrid, tgrid = grids
    pk, gz, _pp, _delp, u, v = _fields(seed=4)
    want = jpgrad.one_grad_p(*(jnp.asarray(a) for a in (u, v, pk, gz)), jgrid, 25.0)
    got = pgrad.one_grad_p(*(torch.from_numpy(a) for a in (u, v, pk, gz)), tgrid, 25.0)
    for name, a, b in zip(("u", "v"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("case", [(0, 30.0), (3, 12.0)], ids=["fields", "partial_k_block"])
def test_nh_p_grad_matches(grids, case, reference):
    jgrid, tgrid = grids
    seed, dt = case
    arrays = _fields(seed=seed)
    pk, gz, pp, delp, u, v = (jnp.asarray(a) for a in arrays)
    if reference == "xla":
        want = jnh.nh_p_grad(u, v, pk, gz, pp, delp, jgrid, dt)
    else:
        want = nh_p_grad_pallas(u, v, pk, gz, pp, delp, jgrid, dt, interpret=True)
    pk, gz, pp, delp, u, v = (torch.from_numpy(a) for a in arrays)
    got = nonhydro.nh_p_grad(u, v, pk, gz, pp, delp, tgrid, dt)
    for name, a, b in zip(("u", "v"), got, want):
        _close(a, b, name)


def test_nh_p_grad_best_takes_the_plain_version_on_cpu(grids):
    _jgrid, tgrid = grids
    pk, gz, pp, delp, u, v = (torch.from_numpy(a) for a in _fields(seed=5))
    before = dict(pgrad_kernel.LAUNCHES)
    got = nonhydro.nh_p_grad_best(u, v, pk, gz, pp, delp, tgrid, 20.0)
    want = nonhydro.nh_p_grad(u, v, pk, gz, pp, delp, tgrid, 20.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pgrad_kernel.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors(grids):
    _jgrid, tgrid = grids
    args = [torch.from_numpy(a) for a in _fields(seed=6)]
    pk, gz, pp, delp, u, v = args
    with pytest.raises(ValueError, match="CUDA device"):
        pgrad_kernel.nh_p_grad_cuda(u, v, pk, gz, pp, delp, tgrid, 10.0)


def test_kernel_grid_operands_have_the_kernel_s_shapes(grids):
    _jgrid, tgrid = grids
    S, Y, X = tgrid.area.shape
    for name, t, shape in pgrad_kernel.grid_operands(tgrid, S, Y, X):
        assert tuple(t.shape) == shape, name


def test_kernel_interior_tiles_need_no_blends():
    """The tiles that the kernel sends down its path without blends
    (``tile_classes`` False) get the same corner values from ``a2b_ord4``
    with the grid as from the interpolation alone, and at C96 such tiles
    and edge tiles both occur on every shard."""
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms

    n = 96
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=3, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device="cpu", dtype=torch.float64)
    S, Y, X = grid.area.shape
    q = torch.from_numpy(np.random.RandomState(7).rand(S, 2, Y, X))
    full, plain = pgrad.a2b_ord4(q, grid), pgrad.a2b_ord4(q, None)
    edge = pgrad_kernel.tile_classes(grid, S, Y, X)
    TY, TX = pgrad_kernel.TILE
    assert edge.shape == (S, -(-(Y + 1) // TY), -(-(X + 1) // TX))
    assert bool(edge.any(-1).any(-1).all()) and bool((~edge).any(-1).any(-1).all())
    for s, a, b in (~edge).nonzero().tolist():
        tile = (s, slice(None), slice(a * TY, a * TY + TY + 1), slice(b * TX, b * TX + TX + 1))
        assert torch.equal(full[tile], plain[tile])
