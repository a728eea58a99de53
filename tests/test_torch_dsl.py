"""The port's stencil layer (pace_tpu_torch/dsl.py): the eleven cases of
tests/main/test_dsl.py on the port, each beside ``pace_tpu``'s answer where
there is one; ``one_grad_p``'s interpolations through one factory-built
``FrozenStencil``, its result unchanged; ``Driver.grid_indexing``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu import dsl as jdsl
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.quantity import SubtileGridSizer as JSizer
from pace_tpu_torch.dsl import (
    CompilationConfig,
    FrozenStencil,
    GridIndexing,
    RunMode,
    StencilConfig,
    StencilFactory,
)
from pace_tpu_torch.quantity import SubtileGridSizer


def test_frozen_stencil_updates_only_window():
    st = FrozenStencil(lambda q: q + 1.0, origin=(2, 2), domain=(3, 4))
    q = torch.zeros((8, 8), dtype=torch.float64)
    out = st(q)
    expect = np.zeros((8, 8))
    expect[2:5, 2:6] = 1.0
    np.testing.assert_array_equal(out.numpy(), expect)
    jout = jdsl.FrozenStencil(lambda q: q + 1.0, origin=(2, 2), domain=(3, 4))(jnp.zeros((8, 8)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert bool((q == 0).all())  # the input is not written


def test_frozen_stencil_multiple_fields_and_outputs():
    st = FrozenStencil(lambda a, b: (a + b, a - b), origin=(1, 1), domain=(2, 2), n_outputs=2)
    oa, ob = st(torch.ones((4, 4)), torch.full((4, 4), 2.0))
    assert float(oa[1, 1]) == 3.0 and float(ob[1, 1]) == -1.0
    assert float(oa[0, 0]) == 1.0 and float(ob[0, 0]) == 2.0  # outside the window


def test_leading_batch_axes_pass_through():
    st = FrozenStencil(lambda q: 2.0 * q, origin=(3, 3), domain=(4, 4))
    out = st(torch.ones((6, 5, 10, 10)))  # (S, K, Y, X): window on the trailing 2 axes
    assert float(out[3, 2, 4, 4]) == 2.0
    assert float(out[3, 2, 0, 0]) == 1.0


def test_validate_args_rejects_shape_change():
    st = FrozenStencil(lambda q: q, origin=(0, 0), domain=(2, 2))
    st(torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        st(torch.zeros((5, 5)))
    with pytest.raises(TypeError):
        st(torch.zeros((4, 4), dtype=torch.float64))


def test_compare_to_numpy_catches_nothing_on_pure_fn():
    cfg = StencilConfig(compare_to_numpy=True)
    st = FrozenStencil(lambda q: q * 3.0, origin=(1, 0), domain=(2, 3), config=cfg)
    st(torch.arange(20.0).reshape(4, 5))  # passes the host cross-check
    # a function whose host evaluation differs is caught
    bad = FrozenStencil(lambda q: q * (3.0 if q.is_contiguous() else 4.0), origin=(1, 0),
                        domain=(2, 3), config=cfg)
    with pytest.raises(AssertionError):
        bad(torch.arange(20.0).reshape(4, 5))


def test_run_mode_build_compiles_without_executing():
    cfg = StencilConfig(CompilationConfig(run_mode=RunMode.Build))
    st = FrozenStencil(lambda q: q + 5.0, origin=(0, 0), domain=(2, 2), config=cfg)
    out = st(torch.zeros((3, 3)))
    np.testing.assert_array_equal(out.numpy(), 0.0)  # not executed


def test_grid_indexing_geometry():
    sizer = SubtileGridSizer.from_tile_params(12, 12, 7, n_halo=3, layout=(2, 2))
    gi = GridIndexing.from_sizer(sizer, shard_y=0, shard_x=1, layout=(2, 2))
    assert gi.domain == (7, 6, 6)
    assert gi.south_edge and gi.east_edge
    assert not gi.north_edge and not gi.west_edge
    assert gi.origin_compute == (0, 3, 3)
    assert gi.domain_full() == (7, 12, 12)
    origin, domain = gi.get_origin_domain(("z", "y", "x_interface"), halos=(1, 0))
    assert origin == (0, 2, 3)
    assert domain == (7, 8, 7)
    jgi = jdsl.GridIndexing.from_sizer(JSizer.from_tile_params(12, 12, 7, n_halo=3, layout=(2, 2)),
                                       shard_y=0, shard_x=1, layout=(2, 2))
    assert gi == GridIndexing(**vars(jgi))
    for dims in (("z", "y", "x_interface"), ("s", "z_interface", "y_interface", "x")):
        assert gi.get_origin_domain(dims, (2, 1)) == jgi.get_origin_domain(dims, (2, 1))


def test_factory_from_dims_halo():
    gi = GridIndexing.from_sizer(SubtileGridSizer.from_tile_params(8, 8, 4, n_halo=3))
    fac = StencilFactory(grid_indexing=gi)
    st = fac.from_dims_halo(lambda q: q + 1.0, ("y", "x"))
    out = st(torch.zeros((4, 14, 14)))
    assert float(out[0, 3, 3]) == 1.0
    assert float(out[0, 2, 2]) == 0.0
    with pytest.raises(ValueError, match="grid_indexing"):
        StencilFactory().from_dims_halo(lambda q: q, ("y", "x"))


def test_grid_indexing_from_halo_matches_model_arrays():
    """GridIndexing of the model's own decomposition describes the padded
    arrays the port allocates, shard for shard as pace_tpu's does."""
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
    from pace_tpu_torch.models.fv3.state import DycoreState

    for layout in ((1, 1), (2, 2)):
        mt = MetricTerms.generate(GridSpec(n_tile=12, npz=5, layout=layout))
        jh = JMetricTerms.generate(JGridSpec(n_tile=12, npz=5, layout=layout)).halo
        h0 = mt.halo
        state = DycoreState.from_baroclinic_init(mt, device="cpu", dtype=torch.float64)
        for s in range(h0.n_shards):
            gi = GridIndexing.from_halo(h0, s, 5)
            nz, ny, nx = gi.domain
            h = gi.n_halo
            assert tuple(state.delp.shape[-3:]) == (nz, ny + 2 * h, nx + 2 * h)
            assert gi == GridIndexing(**vars(jdsl.GridIndexing.from_halo(jh, s, 5)))
        gi0 = GridIndexing.from_halo(h0, 0, 5)
        assert gi0.south_edge and gi0.west_edge
        if layout == (2, 2):
            assert not gi0.north_edge and not gi0.east_edge
            gi3 = GridIndexing.from_halo(h0, 3, 5)
            assert gi3.north_edge and gi3.east_edge


def test_driver_exposes_grid_indexing():
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver

    d = Driver(DriverConfig.from_dict(dict(
        nx_tile=12, nz=4, layout=[1, 1], dt_atmos=60.0, minutes=1,
        dycore_config={"k_split": 1, "n_split": 1, "hydrostatic": True},
        diagnostics_config={"path": "", "output_frequency": 0},
    )), device="cpu")
    gi = d.grid_indexing()
    assert gi.domain == (4, 12, 12)
    assert gi.n_halo == 3
    assert gi.south_edge and gi.north_edge


def test_one_grad_p_consumes_frozen_stencil(monkeypatch):
    """one_grad_p's two corner interpolations go through one factory-built
    FrozenStencil, built once for the grid, and its result is a2b_ord4's contour PGF bit for bit, and
    pace_tpu's one_grad_p's within the tolerance of pace_tpu's own test."""
    from pace_tpu.grid.grid_data import GridData as JGridData
    from pace_tpu.ops import pgrad as jpgrad
    from pace_tpu_torch import dsl
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
    from pace_tpu_torch.grid.grid_data import GridData
    from pace_tpu_torch.ops import pgrad
    from pace_tpu_torch.ops.stencil_utils import bcast_k

    calls = []
    orig = dsl.FrozenStencil.__call__

    def counting(self, *args):
        calls.append(self)
        return orig(self, *args)

    monkeypatch.setattr(dsl.FrozenStencil, "__call__", counting)
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(0)
    S, K, Y, X = 6, 3, 18, 18
    arrays = (rng.randn(S, K, Y + 1, X), rng.randn(S, K, Y, X + 1),
              1.0 + rng.rand(S, K + 1, Y, X), rng.randn(S, K + 1, Y, X) * 100.0)
    u, v, pk, gz = (torch.from_numpy(a) for a in arrays)
    u2, v2 = pgrad.one_grad_p(u, v, pk, gz, grid, 30.0)
    assert len(calls) == 2 and calls[0] is calls[1]
    # built once for the grid: a second step's calls use the same stencil
    pgrad.one_grad_p(u, v, pk, gz, grid, 30.0)
    assert len(calls) == 4 and calls[2] is calls[0] and calls[3] is calls[0]
    pk_b, gz_b = pgrad.a2b_ord4(pk, grid), pgrad.a2b_ord4(gz, grid)
    du = pgrad._pgf_pair(gz_b[..., :, :-1], gz_b[..., :, 1:], pk_b[..., :, :-1],
                         pk_b[..., :, 1:], 30.0, bcast_k(grid.rdx, u))
    assert torch.equal(u2, u + du)
    jgrid = JGridData.from_metric_terms(JMetricTerms.generate(JGridSpec(n_tile=12, npz=3, layout=(1, 1))),
                                        dtype=jnp.float64)
    ju, jv = jpgrad.one_grad_p(*(jnp.asarray(a) for a in arrays), jgrid, 30.0)
    # pace_tpu's test holds its stencil path to its direct one at rtol 1e-8:
    # the random pk columns make the contour denominator nearly cancel (the
    # port's one_grad_p is held to 1e-12 on model states in test_torch_pgrad.py)
    for got, want in ((u2, ju), (v2, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-9)
