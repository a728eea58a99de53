"""The port's PPM, flux preparation, corner folds, grid and dispatch rule
against pace_tpu's.

Inputs are made with numpy from a seed and handed to both packages; float64
throughout. Elementwise chains compare to rtol 1e-12 (XLA's CPU code may
contract a multiply-add where PyTorch rounds twice); the numpy grid
generation is the same code in both packages and must agree exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import fxadv as jfxadv
from pace_tpu.ops import ppm as jppm
from pace_tpu.ops.folds import apply_corner_patch as japply_corner_patch
from pace_tpu_torch import dtypes
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import fxadv, ppm
from pace_tpu_torch.ops._dispatch import route
from pace_tpu_torch.ops.folds import CornerPatch, apply_corner_patch, materialize_qy

RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def grids():
    """C12 grids of both packages; the port's GridData is built from the
    JAX grid's fields, so both transport inputs see identical metrics."""
    spec = dict(n_tile=12, npz=3, layout=(1, 1))
    jmt = JMetricTerms.generate(JGridSpec(**spec))
    tmt = MetricTerms.generate(GridSpec(**spec))
    jgrid = JGridData.from_metric_terms(jmt, dtype=jnp.float64)
    arrays = {f.name: getattr(jgrid, f.name) for f in dataclasses.fields(jgrid)}
    arrays = {k: (v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v))
              for k, v in arrays.items()}
    tgrid = GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)
    return jmt, tmt, jgrid, tgrid


@pytest.mark.parametrize("hord", [1, 5, 6, 7, 8])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_ppm_matches_pace_tpu(hord, axis):
    rng = np.random.default_rng(40 + hord)
    # a field with sign changes and sharp steps so that every limiter acts
    q = rng.standard_normal((2, 3, 14, 14)) + np.where(rng.random((2, 3, 14, 14)) > 0.8, 5.0, 0.0)
    c = 0.9 * (2 * rng.random((2, 3, 14, 14)) - 1)
    fn = {"x": ("xppm", "xppm_i", (0, 1)), "y": ("yppm", "yppm_i", (1, 0))}[axis]
    ref = getattr(jppm, fn[0])(jnp.asarray(q), jnp.asarray(c), hord)
    got = getattr(ppm, fn[0])(_t(q), _t(c), hord)
    _close(got.numpy(), ref)
    dy, dx = fn[2]
    ci = 0.9 * (2 * rng.random((2, 3, 14 + dy, 14 + dx)) - 1)
    ref = getattr(jppm, fn[1])(jnp.asarray(q), jnp.asarray(ci), hord)
    got = getattr(ppm, fn[1])(_t(q), _t(ci), hord)
    _close(got.numpy(), ref)


def test_ppm_rejects_unknown_hord():
    with pytest.raises(ValueError, match="unsupported hord"):
        ppm.xppm(torch.zeros(2, 8), torch.zeros(2, 8), 4)


def test_flux_prep_matches_pace_tpu(grids):
    _, _, jgrid, tgrid = grids
    rng = np.random.default_rng(11)
    S, Y, X = np.asarray(jgrid.area).shape
    uc = 20 * rng.standard_normal((S, 3, Y, X + 1))
    vc = 20 * rng.standard_normal((S, 3, Y + 1, X))
    ref = jfxadv.flux_prep(jnp.asarray(uc), jnp.asarray(vc), jgrid, 600.0)
    got = fxadv.flux_prep(_t(uc), _t(vc), tgrid, 600.0)
    for g, r in zip(got, ref):
        assert g.shape == tuple(r.shape)
        _close(g.numpy(), r)


def test_corner_patch_matches_pace_tpu():
    rng = np.random.default_rng(12)
    q = rng.standard_normal((6, 2, 18, 18))
    p = rng.standard_normal((6, 2, 6, 6))
    ref = np.asarray(japply_corner_patch(jnp.asarray(q), jnp.asarray(p)))
    got = apply_corner_patch(_t(q), CornerPatch(_t(p)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(materialize_qy(_t(q), CornerPatch(_t(p))).numpy(), ref)
    assert materialize_qy(_t(q), _t(p)) is not None
    # the x-fold input is never written
    np.testing.assert_array_equal(_t(q).numpy(), q)


def test_metric_terms_match_pace_tpu(grids):
    """The port's own grid generation, field by field."""
    jmt, tmt, _, _ = grids
    names = [f.name for f in dataclasses.fields(jmt) if f.name != "spec"]
    names += ["rarea", "rdxa", "rdya", "rsin_u", "rsin_v", "xyz_corner", "lon_agrid", "lat_agrid"]
    for name in names:
        ref = getattr(jmt, name)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(getattr(tmt, name), ref, err_msg=name)


def test_grid_data_matches_pace_tpu(grids):
    """GridData built from the port's metric terms against pace_tpu's."""
    _, tmt, jgrid, _ = grids
    tgrid = GridData.from_metric_terms(tmt, device="cpu", dtype=torch.float64)
    for f in dataclasses.fields(jgrid):
        ref = getattr(jgrid, f.name)
        got = getattr(tgrid, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=0,
                                       err_msg=f.name)
            assert got.is_contiguous(), f.name
        else:
            assert got == ref, f.name


def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert route(cpu, None, cpu) == "plain"
    with pytest.raises(ValueError, match="one CUDA device or the CPU"):
        route(cpu, torch.zeros(2, device="meta"))


def test_entry_points_refuse_missing_cuda():
    """The default device is the card; without one an entry point raises
    instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not reachable")
    assert dtypes.DEFAULT_DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dtypes.resolve_device()
    from pace_tpu_torch.demos.tracer_advection import build_case

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_case(n=12, npz=3, nq=1)
    assert dtypes.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="not supported"):
        dtypes.check_dtype(torch.float16)
