"""The port's D->A->C wind transforms against pace_tpu's.

Same inputs (numpy, seeded) through ``pace_tpu.ops.d2a2c.d2a2c_vect`` (XLA
path), its Pallas kernel in interpret mode, and the port's plain PyTorch
version, in float64 at C12. Tolerance: rtol 1e-12 (atol 1e-12 of the
largest reference value, for points that cancel to zero). The XLA path and
the port share their wrap/pad semantics and are compared on the whole
plane; the Pallas kernel wraps where they pad, so it is compared on the
consumed interior (all but the outer three rings), as its own test does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import d2a2c as jd2a2c
from pace_tpu.ops.d2a2c_pallas import d2a2c_vect_pallas
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import d2a2c, d2a2c_kernel

N, NPZ = 12, 4
RTOL = 1e-12
NAMES = ("ua", "va", "uc", "vc", "ut", "vt")


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=what
    )


def grid_arrays(jgrid):
    """A pace_tpu GridData as the dict ``GridData.from_numpy`` takes."""
    out = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        out[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def results():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    tgrid = GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(3)
    S, Y, X = np.asarray(jgrid.area).shape
    u = 10.0 * rng.standard_normal((S, NPZ, Y + 1, X))
    v = 10.0 * rng.standard_normal((S, NPZ, Y, X + 1))
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    return {
        "grids": (jgrid, tgrid),
        "winds": (u, v),
        "xla": dict(zip(NAMES, jd2a2c.d2a2c_vect(ju, jv, jgrid))),
        "pallas": dict(zip(NAMES, d2a2c_vect_pallas(ju, jv, jgrid, interpret=True))),
        "plain": dict(zip(NAMES, d2a2c.d2a2c_plain(tu, tv, tgrid))),
        "dispatched": dict(zip(NAMES, d2a2c.d2a2c_vect(tu, tv, tgrid))),
    }


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_xla(results, name):
    _close(results["plain"][name].numpy(), results["xla"][name], name)


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas_interior(results, name):
    sl = np.s_[:, :, 3:-3, 3:-3]
    _close(results["plain"][name].numpy()[sl], np.asarray(results["pallas"][name])[sl], name)


def test_cpu_tensors_take_the_plain_version(results):
    for name in NAMES:
        assert torch.equal(results["dispatched"][name], results["plain"][name])


@pytest.mark.parametrize("fn", ["u_to_centers", "v_to_centers", "centers_to_x_ifaces",
                                "centers_to_y_ifaces"])
def test_interpolants_match(results, fn):
    u, v = results["winds"]
    a = {"u_to_centers": u, "v_to_centers": v}.get(fn, u[..., :-1, :])
    ref = getattr(jd2a2c, fn)(jnp.asarray(a))
    got = getattr(d2a2c, fn)(torch.from_numpy(a))
    _close(got.numpy(), ref, fn)


def test_cartesian_wind_matches(results):
    jgrid, tgrid = results["grids"]
    u, v = results["winds"]
    ref = jd2a2c.cartesian_wind_centers(jnp.asarray(u), jnp.asarray(v), jgrid)
    got = d2a2c.cartesian_wind_centers(torch.from_numpy(u), torch.from_numpy(v), tgrid)
    _close(got.numpy(), ref, "vcart")


def test_kernel_wrapper_rejects_cpu_tensors(results):
    """The kernel wrapper never runs the plain version: CPU input raises."""
    _, tgrid = results["grids"]
    u, v = results["winds"]
    with pytest.raises(ValueError, match="CUDA device"):
        d2a2c_kernel.d2a2c_cuda(torch.from_numpy(u), torch.from_numpy(v), tgrid)


def test_kernel_operand_shapes_cover_the_grid_fields(results):
    _, tgrid = results["grids"]
    S, Y, X = tgrid.area.shape
    shapes = d2a2c_kernel.grid_shapes(S, Y, X)
    assert tuple(shapes) == d2a2c.GRID_FIELDS
    for f in d2a2c.GRID_FIELDS:
        assert tuple(getattr(tgrid, f).shape) == shapes[f], f
