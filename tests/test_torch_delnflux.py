"""The port's del-n damping operators against pace_tpu's.

Same inputs (numpy, seeded, float64, C12 grid through
``GridData.from_numpy``) through ``pace_tpu.ops.delnflux`` and
``pace_tpu_torch.ops.delnflux`` (plain PyTorch on both sides: these operators
have no kernel of their own). Tolerance: rtol 1e-12 with atol 1e-12 of the
largest reference value, on the whole plane (the pads replicate the edge
identically in both packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import delnflux as jdel
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import delnflux as tdel
from pace_tpu_torch.ops.stencil_utils import bcast_k, x_iface_diff, y_iface_diff

RTOL = 1e-12
K = 3


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def grid_arrays(jgrid):
    out = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        out[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    mt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=K, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    tgrid = GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float64)
    S, Y, X = np.asarray(jgrid.area).shape
    rng = np.random.default_rng(21)
    return dict(jgrid=jgrid, tgrid=tgrid, mt=mt,
                q=rng.standard_normal((S, K, Y, X)),
                qc=rng.standard_normal((S, K, Y + 1, X + 1)) * 1e-5)


@pytest.mark.parametrize("out", ["fx", "fy"])
@pytest.mark.parametrize("nord", [0, 1, 2, 3])
def test_delnflux_matches(setup, nord, out):
    jgrid, tgrid, q = setup["jgrid"], setup["tgrid"], setup["q"]
    ref = jdel.delnflux(jnp.asarray(q), jgrid, nord, 0.15, jgrid.da_min)
    got = tdel.delnflux(_t(q), tgrid, nord, 0.15, tgrid.da_min)
    i = ("fx", "fy").index(out)
    assert got[i].shape == np.asarray(ref[i]).shape
    _close(got[i], ref[i], f"delnflux nord={nord} {out}")


def test_grad_fluxes_match(setup):
    jgrid, tgrid, q = setup["jgrid"], setup["tgrid"], setup["q"]
    ref = jdel._grad_fluxes(jnp.asarray(q), jgrid)
    got = tdel._grad_fluxes(_t(q), tgrid)
    for g, r, nm in zip(got, ref, ("fx", "fy")):
        _close(g, r, nm)


@pytest.mark.parametrize("divg_weights", [False, True])
def test_lap_corner_matches(setup, divg_weights):
    jgrid, tgrid, qc = setup["jgrid"], setup["tgrid"], setup["qc"]
    ref = jdel.lap_corner(jnp.asarray(qc), jgrid, divg_weights=divg_weights)
    got = tdel.lap_corner(_t(qc), tgrid, divg_weights=divg_weights)
    _close(got, ref, f"lap_corner divg_weights={divg_weights}")


@pytest.mark.parametrize("divg_weights", [False, True])
def test_lap_corner_weights(setup, divg_weights):
    """The weights the D-grid tail kernel is handed are lap_corner's own."""
    jgrid, tgrid = setup["jgrid"], setup["tgrid"]
    wgx, wgy = tdel.lap_corner_weights(tgrid, divg_weights)
    S, Y, X = tgrid.area.shape
    assert wgx.shape == (S, Y + 1, X) and wgy.shape == (S, Y, X + 1)
    if divg_weights:
        _close(wgx, jgrid.divg_u(), "divg_u")
        _close(wgy, jgrid.divg_v(), "divg_v")
    else:
        _close(wgx, jgrid.rdx * jgrid.dyc, "wgx")
        _close(wgy, jgrid.rdy * jgrid.dxc, "wgy")


def test_delnflux_f32_no_overflow():
    """(damp_c*da_min)^(nord+1) overflows f32 at production resolutions; the
    factored form must stay finite and damp a noisy field (C24, as pace_tpu's
    own regression test)."""
    mt = JMetricTerms.generate(JGridSpec(n_tile=24, npz=4, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float32)
    grid = GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float32)
    assert (0.15 * grid.da_min) ** 4 > torch.finfo(torch.float32).max
    q = torch.from_numpy(np.random.RandomState(0).randn(6, 4, 30, 30).astype(np.float32))
    fx, fy = tdel.delnflux(q, grid, nord=3, damp_c=0.15, da_min=grid.da_min)
    assert fx.dtype == torch.float32
    assert bool(torch.isfinite(fx).all() and torch.isfinite(fy).all())
    q2 = q + (x_iface_diff(fx) + y_iface_diff(fy)) * bcast_k(grid.rarea, q)
    h = 4
    assert float(q2[..., h:-h, h:-h].var()) < float(q[..., h:-h, h:-h].var())
