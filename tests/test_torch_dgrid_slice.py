"""One acoustic substep up to the vertical solve as a whole: ``c_grid_half``
then ``d_grid_half`` of the port against lines 197-360 of ``pace_tpu``'s
``_one_substep`` composed from its public functions, from the
Jablonowski-Williamson state, in the dycore benchmark's configuration
(``demos.acoustic_substep.bench_config``), nonhydrostatic and hydrostatic.

The state is made once by ``pace_tpu`` (numpy, float64, C12 npz=8,
perturbation on, a random ``w`` added) and handed to both packages through
``DycoreState.from_numpy``. The reference runs through its XLA path (each
Pallas kernel of the path is held in interpret mode by the module tests:
``test_torch_{fvtp2d_multi,d_sw,updatedz_d}.py`` and those of the C-grid
half). Tolerance on the compute domain, the consumed region (fluxes on the
interfaces that bound it): rtol 1e-12 with atol 1e-12 of the largest
reference value. Three outputs of the vertical solve are differences of
pressures near 1e5 Pa, so their absolute tolerance is taken from that scale:
``pp`` 1e-12 of the largest interface pressure, ``w`` that pressure error
times ``dt / dm`` of the lightest layer, ``delz`` the ``w`` error times
``dt``; ``ws`` is the difference of two heights over ``dt``.

One float32 run of the port is held against the float64 reference at 2e-5 of
each output's scale (the largest measured is 5e-6, on ``delz``).
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
from pace_tpu.models.fv3 import acoustics as jacoustics
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu.ops import d_sw as jd_sw
from pace_tpu.ops import nonhydro as jnh
from pace_tpu.ops.c_sw import c_sw as jc_sw
from pace_tpu.ops.folds import CornerPatch as JCornerPatch
from pace_tpu.ops.pgrad import hydrostatic_interfaces as jhydrostatic_interfaces
from pace_tpu.ops.pgrad import p_grad_c as jp_grad_c
from pace_tpu_torch.demos import acoustic_substep as demo
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import acoustics
from pace_tpu_torch.models.fv3.acoustics import DGridHalf, c_grid_half, d_grid_half
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.ops import d_sw

N, NPZ, H = 12, 8, 3
RTOL = 1e-12
F32_TOL = 2e-5
DT = demo.DT
SHARED = ("ds_w", "ds_delp", "ds_pt", "u", "v", "delp", "pt", "mfx", "mfy", "crx", "cry",
          "xfx", "yfx", "heat")
VERTICAL = ("w", "delz", "pp", "pk", "pkz", "gz", "ws")


def _jax_substep(st, grid, halo, cfg, dt):
    """Lines 197-360 of acoustics._one_substep from pace_tpu's public
    functions, in its order (XLA path)."""
    hydro = cfg.hydrostatic
    dt2, ptop = 0.5 * dt, grid.ptop
    fields = [st.delp, st.pt, st.w]
    hdl = halo.start_update_scalars_fold_patches(fields)
    u_y, v_x = halo.update_vector_fold_pair(st.u, st.v, kind="dgrid")
    if not hydro:
        delz, delz_y = halo.update_scalar_folds(st.delz)
    (delp_x, delp_p), (pt_x, pt_p), (w_x, w_p) = hdl.wait()
    cg = jc_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
    _pe, _peln, pkc, pkz_c, gz_c = jhydrostatic_interfaces(cg.delpc, cg.ptc, st.phis, ptop)
    if hydro:
        uc, vc = jp_grad_c(cg.uc, cg.vc, pkc, gz_c, grid, dt2)
    else:
        phis_cx, phis_cy = halo.update_scalar_folds(st.phis)
        zh_cx = jnh.heights_from_delz(delz, phis_cx)
        zh_cy = jnh.heights_from_delz(delz_y, phis_cy)
        zh_c, ws_c = jnh.updatedz_c(zh_cx, zh_cy, cg.xfx, cg.yfx, grid, dt2)
        delz_c = zh_c[..., 1:, :, :] - zh_c[..., :-1, :, :]
        pe_full_c, delz_c_new = jnh.riem_solver_c(
            w_x, delz_c, cg.ptc, cg.delpc, pkz_c, ws_c, dt2, ptop, a_imp=cfg.a_imp,
            p_fac=cfg.p_fac)
        gz_c = jnh.heights_from_delz(delz_c_new, st.phis) * jconstants.GRAV
        uc, vc = jp_grad_c(cg.uc, cg.vc, pe_full_c, gz_c, grid, dt2)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")

    # --- D-grid full step (the third argument is the exchanged w, as there)
    ds = jd_sw.d_sw(u_y, v_x, w_x, delp_x, JCornerPatch(delp_p), pt_x, JCornerPatch(pt_p),
                    w_x, JCornerPatch(w_p), uc_x, vc_x, uc_y, vc_y, cg.divg_d, grid, halo, dt,
                    cfg.d_sw)
    d_t = (cfg.d_sw.d_con / jconstants.CV_AIR) * ds.heat
    cap = cfg.delt_max * abs(dt)
    pt = ds.pt + jnp.clip(d_t, -cap, cap) / pkz_c
    delp_h, pt_h = halo.update_scalars([ds.delp, pt], fold="x")
    out = dict(ds_w=ds.w, ds_delp=ds.delp, ds_pt=ds.pt, u=ds.u, v=ds.v, delp=delp_h, pt=pt_h,
               mfx=ds.mfx, mfy=ds.mfy, crx=ds.crx, cry=ds.cry, xfx=ds.xfx, yfx=ds.yfx,
               heat=ds.heat)
    if hydro:
        return out
    zh_adv = jnh.updatedz_d(zh_cx, zh_cy, ds.crx, ds.cry, ds.xfx, ds.yfx, grid, dt)
    zs = zh_cx[..., -1:, :, :]
    ws = (zh_adv[..., -1:, :, :] - zs)[..., 0, :, :] / dt
    zh_adv = jnp.concatenate([zh_adv[..., :-1, :, :], zs], axis=-3)
    delz = zh_adv[..., 1:, :, :] - zh_adv[..., :-1, :, :]
    _pe, _peln, pk_h, pkz_h, _gz = jhydrostatic_interfaces(delp_h, pt_h, st.phis, ptop)
    w, delz, pp = jnh.riem_solver3(ds.w, delz, pt_h, delp_h, pkz_h, ws, dt, ptop,
                                   a_imp=cfg.a_imp, p_fac=cfg.p_fac)
    w, delz = halo.update_scalars([w, delz], fold="x")
    pp = halo.update_scalar(pp, fold="x")
    gz_if = jnh.heights_from_delz(delz, phis_cx) * jconstants.GRAV
    out.update(w=w, delz=delz, pp=pp, pk=pk_h, pkz=pkz_h, gz=gz_if, ws=ws)
    return out


def _outputs(dhalf: DGridHalf):
    out = {n: getattr(dhalf, n) for n in SHARED[3:] + VERTICAL}
    out.update(ds_w=dhalf.ds.w, ds_delp=dhalf.ds.delp, ds_pt=dhalf.ds.pt)
    return out


def _port_substep(sarrays, garrays, halo, dtype, hydrostatic):
    tgrid = GridData.from_numpy(garrays, device="cpu", dtype=dtype)
    st = DycoreState.from_numpy(sarrays, device="cpu", dtype=dtype)
    cfg = demo.bench_config(hydrostatic)
    delz = None if hydrostatic else st.delz
    chalf = c_grid_half(st.u, st.v, st.w, st.delp, st.pt, delz, st.phis, tgrid, halo, cfg,
                        0.5 * DT, tgrid.ptop)
    return _outputs(d_grid_half(chalf, tgrid, halo, cfg, DT, tgrid.ptop, st.phis))


def _jcfg(hydrostatic):
    tcfg = demo.bench_config(hydrostatic)
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    fields["d_sw"] = jd_sw.DSWConfig(**dataclasses.asdict(tcfg.d_sw))
    return jacoustics.AcousticConfig(**fields)


@pytest.fixture(scope="module")
def substeps():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    jstate = JDycoreState.from_baroclinic_init(mt, perturbation=True, dtype=jnp.float64)
    # a vertical wind for the transport and the solve to act on (the
    # analytic state has w = 0)
    w = 0.5 * np.random.default_rng(0).standard_normal(jstate.delp.shape)
    jstate = dataclasses.replace(jstate, w=jnp.asarray(w))
    garrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        garrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    sarrays = {f.name: None if getattr(jstate, f.name) is None
               else np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    case = demo.build_case(N, NPZ, device="cpu", dtype=torch.float64)
    delp = sarrays["delp"][..., H:-H, H:-H]
    return {
        "case": case,
        "pe_max": float(jgrid.ptop + delp.sum(axis=1).max()),
        "dm_min": float(delp.min()) / jconstants.GRAV,
        "nh": _port_substep(sarrays, garrays, case.halo, torch.float64, False),
        "nh32": _port_substep(sarrays, garrays, case.halo, torch.float32, False),
        "hy": _port_substep(sarrays, garrays, case.halo, torch.float64, True),
        "nh_ref": _jax_substep(jstate, jgrid, mt.halo, _jcfg(False), DT),
        "hy_ref": _jax_substep(jstate, jgrid, mt.halo, _jcfg(True), DT),
    }


def _scale(s, ref, name):
    """The magnitude that ``name``'s absolute tolerance is a fraction of."""
    own = np.abs(np.asarray(ref[name])).max()
    if name == "pp":
        return s["pe_max"]
    if name == "w":
        return max(own, s["pe_max"] * DT / s["dm_min"])
    if name == "delz":
        return max(own, s["pe_max"] * DT / s["dm_min"] * DT)
    if name == "ws":
        return np.abs(np.asarray(ref["gz"])).max() / jconstants.GRAV / DT
    return own


def _consumed(got, want):
    """The compute domain; interface fields keep the interfaces that bound it."""
    dy, dx = want.shape[-2] - (N + 2 * H), want.shape[-1] - (N + 2 * H)
    region = np.s_[..., H:H + N + dy, H:H + N + dx]
    return got[region], want[region]


@pytest.mark.parametrize("name", SHARED + VERTICAL)
def test_nonhydrostatic_substep_matches(substeps, name):
    got, want = substeps["nh"][name].numpy(), np.asarray(substeps["nh_ref"][name])
    assert got.shape == want.shape
    got, want = _consumed(got, want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * _scale(substeps, substeps["nh_ref"], name),
                               err_msg=name)


@pytest.mark.parametrize("name", SHARED + VERTICAL)
def test_hydrostatic_substep_matches(substeps, name):
    got = substeps["hy"][name]
    if name in VERTICAL:
        assert got is None and name not in substeps["hy_ref"]
        return
    got, want = _consumed(got.numpy(), np.asarray(substeps["hy_ref"][name]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("name", ["u", "v", "delp", "pt", "heat", "w", "delz", "pp", "gz", "ws"])
def test_nonhydrostatic_substep_float32(substeps, name):
    got = substeps["nh32"][name]
    assert got.dtype == torch.float32
    got, want = _consumed(got.numpy(), np.asarray(substeps["nh_ref"][name]))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_TOL * _scale(substeps, substeps["nh_ref"], name)


def test_heating_is_capped_and_applied(substeps):
    """pt of the result is d_sw's pt plus the capped heating, exchanged."""
    s = substeps["nh"]
    i = np.s_[..., H:-H, H:-H]
    d_pt = (s["pt"] - s["ds_pt"])[i]
    assert float(d_pt.abs().max()) > 0
    cfg = demo.bench_config()
    # pkz of the C-grid state is below 1.2: |dT| / pkz within the cap / min(pkz)
    assert float(d_pt.abs().max()) <= cfg.delt_max * DT / 0.05


@pytest.mark.parametrize("missing", ["w_x", "zh_x"])
def test_nonhydrostatic_needs_the_nonhydrostatic_c_grid_half(substeps, missing):
    case = substeps["case"]
    st = case.state
    chalf = c_grid_half(st.u, st.v, st.w, st.delp, st.pt, st.delz, st.phis, case.grid,
                        case.halo, case.config, case.dt2, case.grid.ptop)
    broken = dataclasses.replace(chalf, **{missing: None})
    with pytest.raises(ValueError, match="nonhydrostatic mode requires"):
        d_grid_half(broken, case.grid, case.halo, case.config, DT, case.grid.ptop, st.phis)


@pytest.mark.parametrize("cls", ["DSWConfig", "AcousticConfig"])
def test_configs_hold_pace_tpu_fields_and_defaults(cls):
    jcls = getattr(jd_sw if cls == "DSWConfig" else jacoustics, cls)
    tcls = getattr(d_sw if cls == "DSWConfig" else acoustics, cls)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    assert [f.type for f in tf] == [f.type for f in jf]


def test_bench_config_is_the_dycore_benchmark_s():
    cfg = demo.bench_config()
    assert (cfg.hydrostatic, cfg.a_imp, cfg.p_fac) == (False, 1.0, 0.05)
    want = dict(hord_mt=6, hord_vt=6, hord_tm=6, hord_dp=6, nord=3, d4_bg=0.15, d2_bg=0.0,
                d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5, do_vort_damp=True, vtdm4=0.06, d_con=1.0,
                damp_w=0.0, edge_damp_band=True, lap_divg_weights=False)
    assert dataclasses.asdict(cfg.d_sw) == want
    assert DT == 200.0 / 56


@pytest.mark.parametrize("hydrostatic", [False, True])
def test_demo_run_gates(hydrostatic):
    """The user entry point at a small size on the CPU, with the gates
    chip_smoke.py applies at C192."""
    out = demo.run(n=N, npz=NPZ, repeats=2, device="cpu", dtype=torch.float64,
                   hydrostatic=hydrostatic)
    assert out["finite"] and out["delp_min"] > 0
    assert out["mass_drift"] < 1e-13 and out["theta_drift"] < 1e-13
    assert 0 < out["dT_max"] <= out["dT_cap"] * (1 + 1e-9) + 1e-11
    assert len(out["step_ms"]) == 2 and out["device_allocs"] == [0, 0]
    if hydrostatic:
        assert out["dhalf"].w is None and "delz_max" not in out
    else:
        assert out["w_drift"] < 1e-13
        assert out["delz_max"] < 0 and out["zs_err"] < 1e-9
        assert out["pp_rel_max"] < 1e-4 and out["ws_max"] < 0.01
    bal = demo.steady_state_residual(n=N, npz=NPZ, device="cpu", dtype=torch.float64,
                                     hydrostatic=hydrostatic)
    assert 0.5 < bal["ratio"] < 5.0
