"""The nonhydrostatic C-grid half of an acoustic substep as a whole:
``c_grid_half(hydrostatic=False)`` of the port against the same lines of
``pace_tpu``'s ``_one_substep`` composed from its public functions, from the
Jablonowski-Williamson state.

The state is made once by ``pace_tpu`` (numpy, float64, C12 npz=8,
perturbation on) and handed to both packages. The reference runs twice:
through the XLA path, and through the six Pallas kernels of the path (d2a2c,
the c_sw tail, the hydrostatic chain, the heights, updatedz_c and sim1) in
interpret mode. Tolerance on the compute domain, the consumed region: rtol
1e-12 with atol 1e-12 of the largest reference value, against both. As in the
hydrostatic slice test, against the Pallas composition the C-grid winds are
compared off the tile-edge interface lines, where pace_tpu's two d2a2c paths
differ. ``ws_c`` is the difference of two heights over ``dt2``, so its
absolute tolerance is that of the heights over ``dt2``.

One float32 run of the port is held against the float64 reference at 2e-5 of
each output's largest value (about 300 float32 ulps; the largest measured is
2.6e-6, on ``pe_c``): the solve is driven by the difference of two pressures
near 1e5 Pa, each rounded to float32.
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
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.ops import nonhydro as jnh
from pace_tpu.ops.c_sw import c_sw as jc_sw
from pace_tpu.ops.c_sw_tail_pallas import c_sw_tail_pallas
from pace_tpu.ops.d2a2c_pallas import d2a2c_vect_pallas
from pace_tpu.ops.hydro_pallas import hydrostatic_interfaces_pallas
from pace_tpu.ops.pgrad import hydrostatic_interfaces as jhydrostatic_interfaces
from pace_tpu.ops.pgrad import p_grad_c as jp_grad_c
from pace_tpu.ops.sim1_pallas import sim1_solver_pallas
from pace_tpu.ops.updatedz_pallas import heights_from_delz_pallas, updatedz_c_pallas
from pace_tpu_torch.demos import cgrid_half_step as demo
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3.acoustics import AcousticConfig, c_grid_half
from pace_tpu_torch.models.fv3.state import DycoreState

N, NPZ = 12, 8
RTOL = 1e-12
F32_TOL = 2e-5
A_IMP, P_FAC = 1.0, 0.05
OUTPUTS = ("u_y", "v_x", "delp_x", "delp_p", "pt_x", "pt_p", "w_x", "w_p", "pkz_c", "delpc",
            "ptc", "cg_uc", "cg_vc", "ut", "vt", "ua", "va", "divg_d", "xfx", "yfx", "delz_x",
            "zh_x", "zh_y", "phis_x", "phis_y", "zh_c", "ws_c", "delz_c", "pe_c", "uc_x",
            "vc_x", "uc_y", "vc_y")
#: C-grid winds whose tile-edge lines depend on d2a2c's unspecified ring
EDGE_LINE_WINDS = ("uc_x", "vc_x", "uc_y", "vc_y", "cg_uc", "cg_vc")


def _jax_nh_c_grid_half(st, grid, halo, dt2, pallas):
    """acoustics._one_substep's C-grid half (nonhydrostatic branch) from
    pace_tpu's public functions, in its order; ``pallas`` runs the path's six
    Pallas kernels in interpret mode."""
    ptop = grid.ptop
    hdl = halo.start_update_scalars_fold_patches([st.delp, st.pt, st.w])
    u_y, v_x = halo.update_vector_fold_pair(st.u, st.v, kind="dgrid")
    delz, delz_y = halo.update_scalar_folds(st.delz)
    (delp_x, delp_p), (pt_x, pt_p), (w_x, w_p) = hdl.wait()
    phis_cx, phis_cy = halo.update_scalar_folds(st.phis)
    if not pallas:
        cg = jc_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
        pkz_c = jhydrostatic_interfaces(cg.delpc, cg.ptc, st.phis, ptop)[3]
        zh_cx = jnh.heights_from_delz(delz, phis_cx)
        zh_cy = jnh.heights_from_delz(delz_y, phis_cy)
        zh_c, ws_c = jnh.updatedz_c(zh_cx, zh_cy, cg.xfx, cg.yfx, grid, dt2)
        delz_c = zh_c[..., 1:, :, :] - zh_c[..., :-1, :, :]
        pe_full_c, delz_c_new = jnh.riem_solver_c(
            w_x, delz_c, cg.ptc, cg.delpc, pkz_c, ws_c, dt2, ptop, a_imp=A_IMP, p_fac=P_FAC)
        gz_c = jnh.heights_from_delz(delz_c_new, st.phis) * jconstants.GRAV
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
        pkz_c = hydrostatic_interfaces_pallas(cg.delpc, cg.ptc, st.phis, ptop, need=("pkz",),
                                              interpret=True)[3]
        zh_cx = heights_from_delz_pallas(delz, phis_cx, interpret=True)
        zh_cy = heights_from_delz_pallas(delz_y, phis_cy, interpret=True)
        zh_c, ws_c = updatedz_c_pallas(zh_cx, zh_cy, cg.xfx, cg.yfx, grid.area, dt2,
                                       interpret=True)
        delz_c = zh_c[..., 1:, :, :] - zh_c[..., :-1, :, :]
        _w, delz_c_new, pp = sim1_solver_pallas(w_x, delz_c, cg.ptc, cg.delpc, pkz_c, ws_c,
                                                dt2, ptop, p_fac=P_FAC, interpret=True)
        pe_below = ptop + jnp.cumsum(cg.delpc, axis=-3)
        pe_full_c = jnp.concatenate(
            [jnp.full_like(pe_below[..., :1, :, :], ptop), pe_below], axis=-3) + pp
        gz_c = heights_from_delz_pallas(delz_c_new, st.phis, interpret=True) * jconstants.GRAV
    uc, vc = jp_grad_c(cg.uc, cg.vc, pe_full_c, gz_c, grid, dt2)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    return dict(
        uc_x=uc_x, vc_x=vc_x, uc_y=uc_y, vc_y=vc_y, u_y=u_y, v_x=v_x, delp_x=delp_x,
        delp_p=delp_p, pt_x=pt_x, pt_p=pt_p, w_x=w_x, w_p=w_p, pkz_c=pkz_c, delpc=cg.delpc,
        ptc=cg.ptc, cg_uc=cg.uc, cg_vc=cg.vc, ut=cg.ut, vt=cg.vt, ua=cg.ua, va=cg.va,
        divg_d=cg.divg_d, xfx=cg.xfx, yfx=cg.yfx, delz_x=delz, zh_x=zh_cx, zh_y=zh_cy,
        phis_x=phis_cx, phis_y=phis_cy, zh_c=zh_c, ws_c=ws_c, delz_c=delz_c_new,
        pe_c=pe_full_c,
    )


def _outputs(half):
    cg = half.cg
    return dict(
        uc_x=half.uc_x, vc_x=half.vc_x, uc_y=half.uc_y, vc_y=half.vc_y, u_y=half.u_y,
        v_x=half.v_x, delp_x=half.delp_x, delp_p=half.delp_y.data, pt_x=half.pt_x,
        pt_p=half.pt_y.data, w_x=half.w_x, w_p=half.w_y.data, pkz_c=half.pkz_c,
        delpc=cg.delpc, ptc=cg.ptc, cg_uc=cg.uc, cg_vc=cg.vc, ut=cg.ut, vt=cg.vt, ua=cg.ua,
        va=cg.va, divg_d=cg.divg_d, xfx=cg.xfx, yfx=cg.yfx, delz_x=half.delz_x,
        zh_x=half.zh_x, zh_y=half.zh_y, phis_x=half.phis_folds[0], phis_y=half.phis_folds[1],
        zh_c=half.zh_c, ws_c=half.ws_c, delz_c=half.delz_c, pe_c=half.pe_c,
    )


def _port_half(sarrays, garrays, halo, dtype):
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=dtype)
    st = DycoreState.from_numpy(sarrays, device="cpu", dtype=dtype)
    cfg = AcousticConfig(hydrostatic=False, a_imp=A_IMP, p_fac=P_FAC)
    return _outputs(c_grid_half(st.u, st.v, st.w, st.delp, st.pt, st.delz, st.phis, tgrid,
                                halo, cfg, demo.DT2, tgrid.ptop))


@pytest.fixture(scope="module")
def halves():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    # a vertical wind for the solve to act on (the analytic state has w = 0)
    w = 0.5 * np.random.default_rng(0).standard_normal(jstate.delp.shape)
    jstate = dataclasses.replace(jstate, w=jnp.asarray(w))
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None else np.asarray(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    case = demo.build_case(N, NPZ, device="cpu", dtype=torch.float64, hydrostatic=False)
    return {
        "case": case, "sarrays": sarrays, "garrays": garrays,
        "got": _port_half(sarrays, garrays, case.halo, torch.float64),
        "got32": _port_half(sarrays, garrays, case.halo, torch.float32),
        "xla": _jax_nh_c_grid_half(jstate, jgrid, mt.halo, demo.DT2, pallas=False),
        "pallas": _jax_nh_c_grid_half(jstate, jgrid, mt.halo, demo.DT2, pallas=True),
    }


def _scale(ref, name):
    """The magnitude that ``name``'s absolute tolerance is a fraction of."""
    if name == "ws_c":
        return np.abs(np.asarray(ref["zh_c"])).max() / demo.DT2
    return np.abs(np.asarray(ref[name])).max()


def _consumed(name, got, want, off_edge_lines):
    if off_edge_lines and name in EDGE_LINE_WINDS:
        return got[..., 4:-4, 4:-4], want[..., 4:-4, 4:-4]
    if name.endswith("_p"):  # corner packs are consumed whole
        return got, want
    return got[..., 3:-3, 3:-3], want[..., 3:-3, 3:-3]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_nh_c_grid_half_matches(halves, name, ref):
    got = halves["got"][name].numpy()
    want = np.asarray(halves[ref][name])
    assert got.shape == want.shape
    got, want = _consumed(name, got, want, off_edge_lines=ref == "pallas")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * _scale(halves[ref], name),
                               err_msg=f"{name} vs {ref}")


@pytest.mark.parametrize("name", ["zh_c", "ws_c", "delz_c", "pe_c", "uc_x", "vc_y"])
def test_nh_c_grid_half_float32(halves, name):
    got = halves["got32"][name]
    assert got.dtype == torch.float32
    got, want = _consumed(name, got.numpy(), np.asarray(halves["xla"][name]), False)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_TOL * _scale(halves["xla"], name)


def test_hydrostatic_branch_is_unchanged_by_the_carried_fields(halves):
    """``w`` rides along in the hydrostatic configuration (it is exchanged
    for the D-grid half) without touching the other results, and the
    nonhydrostatic fields of the result stay empty."""
    case, sarrays = halves["case"], halves["sarrays"]
    st = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    grid = GridData.from_numpy(halves["garrays"], device="cpu", dtype=torch.float64)
    args = (st.delp, st.pt, None, st.phis, grid, case.halo, AcousticConfig(), demo.DT2,
            grid.ptop)
    a = c_grid_half(st.u, st.v, None, *args)
    b = c_grid_half(st.u, st.v, st.w, *args)
    assert a.w_x is None and b.w_x is not None
    for f in ("uc_x", "vc_x", "uc_y", "vc_y", "pkz_c"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    for f in ("delz_x", "zh_x", "zh_y", "phis_folds", "zh_c", "ws_c", "delz_c", "pe_c"):
        assert getattr(a, f) is None


def test_phis_folds_argument_is_used(halves):
    """Passing the exchanged ``phis`` gives the same half step as letting
    ``c_grid_half`` exchange it."""
    case, sarrays = halves["case"], halves["sarrays"]
    st = DycoreState.from_numpy(sarrays, device="cpu", dtype=torch.float64)
    grid = GridData.from_numpy(halves["garrays"], device="cpu", dtype=torch.float64)
    folds = case.halo.update_scalar_folds(st.phis)
    half = c_grid_half(st.u, st.v, st.w, st.delp, st.pt, st.delz, st.phis, grid, case.halo,
                       AcousticConfig(hydrostatic=False), demo.DT2, grid.ptop,
                       phis_folds=folds)
    assert half.phis_folds is folds
    assert torch.equal(half.uc_x, halves["got"]["uc_x"])
    assert torch.equal(half.zh_y, halves["got"]["zh_y"])


@pytest.mark.parametrize("missing", ["w", "delz"])
def test_nonhydrostatic_needs_w_and_delz(halves, missing):
    case = halves["case"]
    st = case.state
    w, delz = (None, st.delz) if missing == "w" else (st.w, None)
    with pytest.raises(ValueError, match="requires w and delz"):
        c_grid_half(st.u, st.v, w, st.delp, st.pt, delz, st.phis, case.grid, case.halo,
                    AcousticConfig(hydrostatic=False), demo.DT2, case.grid.ptop)


def test_demo_run_gates():
    """The user entry point at a small size on the CPU, with the gates
    chip_smoke.py applies at C192."""
    out = demo.run(n=N, npz=NPZ, repeats=2, device="cpu", dtype=torch.float64,
                   hydrostatic=False)
    assert out["finite"] and out["delpc_min"] > 0
    assert out["mass_drift"] < 1e-13
    assert out["delz_c_max"] < 0 and out["dzh_min"] > 0
    assert out["zs_pin_err"] == 0.0 and out["zs_err"] < 1e-9
    assert out["pp_rel_max"] < 1e-4 and out["ws_max"] < 0.01
    assert len(out["step_ms"]) == 2
    bal = demo.steady_state_residual(n=N, npz=NPZ, device="cpu", dtype=torch.float64,
                                     hydrostatic=False)
    assert 0 < bal["ratio"] < 0.25
