"""The C-grid half of an acoustic substep as a whole: ``c_grid_half`` of the
port against the same lines of ``pace_tpu``'s ``_one_substep`` composed from
its public functions, from the Jablonowski-Williamson state.

The state is made once by ``pace_tpu`` (numpy, float64, C12, perturbation
on) and handed to both packages (``GridData.from_numpy``,
``DycoreState.from_numpy``). The reference runs twice: through the XLA path
and through the three Pallas kernels of the path (d2a2c, the c_sw tail, the
hydrostatic chain) in interpret mode. Tolerance: rtol 1e-12 (atol 1e-12 of
the largest reference value) on the consumed region, the compute domain.

One exception, a property of ``pace_tpu`` itself: next to a tile's north and
east edge the c_sw tail's kinetic energy reads ``vc[Y-2]`` / ``uc[:, X-2]``
of d2a2c, a ring that the XLA path (edge pads) and the Pallas d2a2c kernel
(wrap-around rolls) fill differently (1.2e-5 m/s here). The port follows the
XLA path, so against the Pallas composition the C-grid winds are compared
off the tile-edge interface lines.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.ops.c_sw import c_sw as jc_sw
from pace_tpu.ops.c_sw_tail_pallas import c_sw_tail_pallas
from pace_tpu.ops.d2a2c_pallas import d2a2c_vect_pallas
from pace_tpu.ops.hydro_pallas import hydrostatic_interfaces_pallas
from pace_tpu.ops.pgrad import hydrostatic_interfaces as jhydrostatic_interfaces
from pace_tpu.ops.pgrad import p_grad_c as jp_grad_c
from pace_tpu_torch.demos import cgrid_half_step as demo
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3.acoustics import AcousticConfig, c_grid_half
from pace_tpu_torch.models.fv3.state import DycoreState

N, NPZ = 12, 8
RTOL = 1e-12
OUTPUTS = ("uc_x", "vc_x", "uc_y", "vc_y", "u_y", "v_x", "delp_x", "delp_p", "pt_x", "pt_p",
           "pkz_c", "delpc", "ptc", "cg_uc", "cg_vc", "ut", "vt", "ua", "va", "divg_d",
           "xfx", "yfx")
#: C-grid winds whose tile-edge lines depend on d2a2c's unspecified ring
EDGE_LINE_WINDS = ("uc_x", "vc_x", "uc_y", "vc_y", "cg_uc", "cg_vc")


def _jax_c_grid_half(st, grid, halo, dt2, pallas):
    """acoustics._one_substep's C-grid half (hydrostatic branch) from
    pace_tpu's public functions; ``pallas`` runs the path's three Pallas
    kernels in interpret mode."""
    hdl = halo.start_update_scalars_fold_patches([st.delp, st.pt])
    u_y, v_x = halo.update_vector_fold_pair(st.u, st.v, kind="dgrid")
    (delp_x, delp_p), (pt_x, pt_p) = hdl.wait()
    if not pallas:
        cg = jc_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
        _pe, _peln, pkc, pkz_c, gz_c = jhydrostatic_interfaces(cg.delpc, cg.ptc, st.phis, grid.ptop)
    else:
        ua, va, uc, vc, _ut, _vt = d2a2c_vect_pallas(u_y, v_x, grid, interpret=True)
        uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
        ucx, vcx = halo.update_vector(uc, vc, kind="cgrid", fold="x")
        ucy, vcy = halo.update_vector(uc, vc, kind="cgrid", fold="y")
        ua_y, va_x = halo.update_vector_fold_pair(ua, va, kind="agrid")
        tail = c_sw_tail_pallas(u_y, v_x, delp_x, pt_x, uc, vc, ucx, vcx, ucy, vcy,
                                ua, va, va_x, ua_y, grid, dt2, interpret=True)
        delpc, ptc, uc_new, vc_new, ut, vt, xfx, yfx, divg_d = tail
        divg_d = halo.update_scalar(divg_d, stagger="corner", fold="x")
        cg = dataclasses.make_dataclass("CG", ["delpc", "ptc", "uc", "vc", "ut", "vt", "ua",
                                               "va", "divg_d", "xfx", "yfx"])(
            delpc, ptc, uc_new, vc_new, ut, vt, ua, va, divg_d, xfx, yfx)
        _pe, _peln, pkc, pkz_c, gz_c = hydrostatic_interfaces_pallas(
            cg.delpc, cg.ptc, st.phis, grid.ptop, need=("pk", "pkz", "gz"), interpret=True)
    uc, vc = jp_grad_c(cg.uc, cg.vc, pkc, gz_c, grid, dt2)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    return dict(
        uc_x=uc_x, vc_x=vc_x, uc_y=uc_y, vc_y=vc_y, u_y=u_y, v_x=v_x, delp_x=delp_x,
        delp_p=delp_p, pt_x=pt_x, pt_p=pt_p, pkz_c=pkz_c, delpc=cg.delpc, ptc=cg.ptc,
        cg_uc=cg.uc, cg_vc=cg.vc, ut=cg.ut, vt=cg.vt, ua=cg.ua, va=cg.va,
        divg_d=cg.divg_d, xfx=cg.xfx, yfx=cg.yfx,
    )


@pytest.fixture(scope="module")
def halves():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None else np.asarray(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=torch.float64)
    tstate = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    case = demo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    half = c_grid_half(tstate.u, tstate.v, None, tstate.delp, tstate.pt, None, tstate.phis,
                       tgrid, case.halo, AcousticConfig(), demo.DT2, tgrid.ptop)
    got = dict(
        uc_x=half.uc_x, vc_x=half.vc_x, uc_y=half.uc_y, vc_y=half.vc_y, u_y=half.u_y,
        v_x=half.v_x, delp_x=half.delp_x, delp_p=half.delp_y.data, pt_x=half.pt_x,
        pt_p=half.pt_y.data, pkz_c=half.pkz_c, delpc=half.cg.delpc, ptc=half.cg.ptc,
        cg_uc=half.cg.uc, cg_vc=half.cg.vc, ut=half.cg.ut, vt=half.cg.vt, ua=half.cg.ua,
        va=half.cg.va, divg_d=half.cg.divg_d, xfx=half.cg.xfx, yfx=half.cg.yfx,
    )
    return {
        "got": got, "tstate": tstate, "case": case,
        "xla": _jax_c_grid_half(jstate, jgrid, mt.halo, demo.DT2, pallas=False),
        "pallas": _jax_c_grid_half(jstate, jgrid, mt.halo, demo.DT2, pallas=True),
    }


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_c_grid_half_matches(halves, name, ref):
    got = halves["got"][name].numpy()
    want = np.asarray(halves[ref][name])
    assert got.shape == want.shape
    if ref == "pallas" and name in EDGE_LINE_WINDS:
        got, want = got[..., 4:-4, 4:-4], want[..., 4:-4, 4:-4]
    elif not name.endswith("_p"):  # corner packs are consumed whole
        got, want = got[..., 3:-3, 3:-3], want[..., 3:-3, 3:-3]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=f"{name} vs {ref}")


def test_state_round_trip_and_demo_state(halves):
    """``DycoreState.from_numpy`` carries every populated field, and the
    port's own JW state equals pace_tpu's."""
    tstate, case = halves["tstate"], halves["case"]
    back = tstate.to_numpy()
    mine = case.state.to_numpy()
    assert set(back) == set(mine)
    for k, v in back.items():
        np.testing.assert_allclose(mine[k], v, rtol=RTOL, atol=RTOL * np.abs(v).max(), err_msg=k)
    assert case.state.tracer("qvapor").shape == tstate.delp.shape
    z = DycoreState.init_zeros(dict(S=6, K=2, Y=5, X=4), device="cpu", dtype=torch.float64)
    assert z.u.shape == (6, 2, 6, 4) and z.pe.shape == (6, 3, 5, 4) and float(z.q.abs().sum()) == 0


def test_nonhydrostatic_configuration_is_refused(halves):
    st, case = halves["tstate"], halves["case"]
    with pytest.raises(NotImplementedError, match="rows 8, 9 and 11"):
        c_grid_half(st.u, st.v, st.w, st.delp, st.pt, st.delz, st.phis, case.grid, case.halo,
                    AcousticConfig(hydrostatic=False), demo.DT2, case.grid.ptop)


def test_demo_run_gates():
    """The user entry point at a small size on the CPU, with the gates
    chip_smoke.py applies at C192."""
    out = demo.run(n=N, npz=NPZ, repeats=2, device="cpu", dtype=torch.float64)
    assert out["finite"] and out["delpc_min"] > 0
    assert out["mass_drift"] < 1e-13
    assert out["pt_floor"] <= out["ptc_min"] and out["ptc_max"] <= out["pt_ceil"]
    assert 0 < out["pkz_min"] and out["pkz_max"] < 1.2
    assert len(out["step_ms"]) == 2
    bal = demo.steady_state_residual(n=N, npz=NPZ, device="cpu", dtype=torch.float64)
    assert 0 < bal["ratio"] < 0.25
