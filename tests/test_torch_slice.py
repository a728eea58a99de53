"""The transport slice as a whole: the tracer-advection demo step in both
packages from identical inputs.

One step is the delp mass flux (fvtp2d, hord 6, y-fold as a corner pack),
the cgrid interface sync and ``advect_tracers(hord=8, dynamic=True)`` over
the stacked tracer block. The inputs (grid fields, tracers, layer
thicknesses, Courant numbers, area fluxes) are made once with numpy and
handed to both packages. After 3 steps q and dp agree on the interior to
rtol 1e-12 in float64. The long time step gives a max Courant number above
1, so the dynamic sub-cycle count is 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import _dispatch as jdispatch
from pace_tpu.ops.folds import CornerPatch as JCornerPatch
from pace_tpu.ops.fvtp2d import fvtp2d_best as jfvtp2d_best
from pace_tpu.ops.tracer_advection import advect_tracers as jadvect_tracers
from pace_tpu_torch.demos import tracer_advection as demo
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops.tracer_advection import subcycle_count

N, NPZ, NQ, STEPS = 12, 3, 2, 3
RTOL = 1e-12


@pytest.fixture(scope="module")
def jax_side():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    return mt.halo, JGridData.from_metric_terms(mt, dtype=jnp.float64)


def _jax_step(halo, grid, case, batched):
    crx, cry, xfx, yfx = (jnp.asarray(case[k]) for k in ("crx", "cry", "xfx", "yfx"))

    def step(q, delp):
        dpx, dpp = halo.update_scalar_fold_patch(delp)
        fl = jfvtp2d_best(dpx, JCornerPatch(dpp), crx, cry, xfx, yfx, grid.area, 6)
        mfx, mfy = halo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
        orig = jdispatch.use_pallas
        try:
            if batched:  # the tracer-block Pallas kernel, in interpret mode on the CPU
                jdispatch.use_pallas = lambda name: name == "fvtp2d"
            return jadvect_tracers(
                q, delp, crx, cry, xfx, yfx, mfx, mfy, halo, grid, hord=8, dynamic=True
            )
        finally:
            jdispatch.use_pallas = orig

    return jax.jit(step)


@pytest.mark.parametrize(
    "dt,n_sub,batched",
    [(1800.0, 1, False), (30000.0, 2, False), (30000.0, 2, True)],
    ids=["courant<1", "courant>1", "courant>1-pallas"],
)
def test_demo_steps_match_pace_tpu(jax_side, dt, n_sub, batched):
    jhalo, jgrid = jax_side
    arrays = {f.name: getattr(jgrid, f.name) for f in dataclasses.fields(jgrid)}
    arrays = {k: (v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v))
              for k, v in arrays.items()}
    tgrid = GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)
    # the inputs as the port's demo makes them, handed to both packages
    made = demo.build_case(N, NPZ, NQ, dt, device="cpu", dtype=torch.float64)
    inputs = made.to_numpy()
    case = demo.TracerCase.from_numpy(inputs, tgrid, made.halo, device="cpu",
                                      dtype=torch.float64)
    assert subcycle_count(case.crx, case.cry, tgrid.n_halo) == n_sub

    jstep = _jax_step(jhalo, jgrid, inputs, batched)
    jq, jdp = jnp.asarray(inputs["q"]), jnp.asarray(inputs["delp"])
    q, dp = case.q, case.delp
    for _ in range(STEPS):
        jq, jdp = jstep(jq, jdp)
        q, dp = demo.step(case, q, dp)

    h = tgrid.n_halo
    inner = np.s_[..., h:-h, h:-h]
    for got, ref in ((q, jq), (dp, jdp)):
        got, ref = got.numpy()[inner], np.asarray(ref)[inner]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    # the run moved the tracers, and hord 8 kept them monotone
    q0 = inputs["q"][inner]
    assert np.abs(q.numpy()[inner] - q0).max() > 1.0
    assert q.numpy()[inner].min() >= q0.min() - 1e-9 * (q0.max() - q0.min())


def test_demo_run_diagnostics():
    """The user entry point at a small size on the CPU: conservation,
    monotonicity and finiteness as chip_smoke.py checks them at C192."""
    out = demo.run(n=N, npz=NPZ, nq=NQ, dt=30000.0, steps=2, device="cpu",
                   dtype=torch.float64)
    assert out["n_subcycles"] == 2
    assert out["finite"]
    assert out["mass_drift"] < 1e-12
    assert out["q_min"] >= out["q_floor"]
    assert len(out["step_ms"]) == 2
