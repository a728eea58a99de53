"""The port's D-grid shallow-water step (d_sw) against pace_tpu's.

Same inputs (numpy, seeded) through both packages in float64 at C12.
Tolerance: rtol 1e-12 with atol 1e-12 of the largest reference value (for
points that cancel to zero). The tail (``d_sw_tail_plain``) is held on the
whole plane against ``d_sw_tail_jnp`` and against the Pallas kernel in
interpret mode, in the two configurations of
tests/main/test_dsw_tail_pallas.py (the benchmark's damping set; nord=1
without band, heat and vorticity damping) and with the Laplacian's two
weightings: its pads replicate the edge identically on every side. The whole
``d_sw`` runs on exchanged fields and is held on the compute domain, the
fluxes on the interfaces of the compute domain.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import d_sw as jd_sw
from pace_tpu.ops.d_sw_tail_pallas import d_sw_tail_pallas
from pace_tpu.ops.folds import CornerPatch as JCornerPatch
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import d_sw, d_sw_tail_kernel
from pace_tpu_torch.ops.folds import CornerPatch
from pace_tpu_torch.parallel.halo import HaloExchanger
from pace_tpu_torch.parallel.partitioner import CubedSpherePartitioner, TilePartitioner
from pace_tpu_torch.parallel.topology import cubed_sphere_topology

N, NPZ = 12, 11
H = 3
RTOL = 1e-12
DT = 200.0 / 56
BENCH = dict(nord=3, d4_bg=0.15, d2_bg=0.0, d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5,
             do_vort_damp=True, vtdm4=0.06, d_con=1.0)
PLAIN = dict(nord=1, d4_bg=0.16, dddmp=0.0, d_con=0.0, vtdm4=0.0, edge_damp_band=False)
#: the two configurations of pace_tpu's own tail test, and two more that
#: reach the other switches (nord 0 and 2, the divg_u/divg_v weighting)
TAIL_CFGS = {
    "bench": BENCH,
    "nord1": PLAIN,
    "divg_weights": dict(BENCH, nord=2, lap_divg_weights=True),
    "nord0": dict(PLAIN, nord=0, d2_bg=0.02, d_con=0.5),
}
TAIL_OUT = ("u_new", "v_new", "heat")
RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(d_sw.DSWResult))


def _close(got, ref, what, region=np.s_[...]):
    got, ref = np.asarray(got)[region], np.asarray(ref)[region]
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=what)


def grid_arrays(jgrid):
    out = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        out[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    tgrid = GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float64)
    thalo = HaloExchanger(
        cubed_sphere_topology(), CubedSpherePartitioner(TilePartitioner((1, 1))), N
    )
    S, Y, X = np.asarray(jgrid.area).shape
    rng = np.random.default_rng(13)

    def r(dy=0, dx=0, scale=1.0, offset=0.0):
        return offset + scale * rng.standard_normal((S, NPZ, Y + dy, X + dx))

    tail = dict(u=r(1, 0), v=r(0, 1), ut=r(0, 1), vt=r(1, 0), divg_d=r(1, 1, 1e-5),
                vort=r(scale=1e-5), vfx=r(0, 1), vfy=r(1, 0), dvfx=r(0, 1), dvfy=r(1, 0))
    state = dict(u=r(1, 0, 10.0), v=r(0, 1, 10.0), w=r(scale=0.5),
                 delp=r(scale=50.0, offset=1000.0), pt=r(scale=10.0, offset=300.0),
                 uc=r(0, 1, 10.0), vc=r(1, 0, 10.0), divg_d=r(1, 1, 1e-5))
    return dict(jgrid=jgrid, tgrid=tgrid, jhalo=mt.halo, thalo=thalo, tail=tail, state=state)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_absolute_vorticity_centers_matches(setup):
    f = setup["tail"]
    ref = jd_sw.absolute_vorticity_centers(jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                                           setup["jgrid"])
    got = d_sw.absolute_vorticity_centers(_t(f["u"]), _t(f["v"]), setup["tgrid"])
    _close(got, ref, "vorticity")


def test_kinetic_energy_corners_matches(setup):
    f = setup["tail"]
    names = ("u", "v", "ut", "vt")
    ref = jd_sw.kinetic_energy_corners(*(jnp.asarray(f[n]) for n in names), setup["jgrid"], DT)
    got = d_sw.kinetic_energy_corners(*(_t(f[n]) for n in names), setup["tgrid"], DT)
    _close(got, ref, "dt*ke")
    # the cube-corner fix moved the four corner points of every shard and level
    plain_grid = dataclasses.replace(setup["tgrid"], corner_table=())
    assert len(setup["tgrid"].corner_table) == 4
    assert got.shape == d_sw.kinetic_energy_corners(
        *(_t(f[n]) for n in names), plain_grid, DT).shape


@pytest.mark.parametrize("K", [1, 2, 5])
def test_damping_profile_matches(K):
    cfg = dict(d2_bg=0.05, d2_bg_k1=0.2, d2_bg_k2=0.01)
    ref = jd_sw.damping_profile(jd_sw.DSWConfig(**cfg), K, jnp.float64)
    got = d_sw.damping_profile(d_sw.DSWConfig(**cfg), K, torch.float64)
    assert got.shape == (K, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert d_sw.damping_column(d_sw.DSWConfig(**cfg), K) == got.flatten().tolist()


def test_edge_band(setup):
    """1 on the tile-edge corner rows and columns (interfaces 3 and 15 of the
    18-cell plane), 0 elsewhere."""
    band = d_sw.edge_band(setup["tgrid"]).numpy()
    want = np.zeros_like(band)
    want[:, [H, H + N], :] = 1.0
    want[:, :, [H, H + N]] = 1.0
    np.testing.assert_array_equal(band, want)


# ---------------------------------------------------------------------------
# the tail
# ---------------------------------------------------------------------------


def _tail_args(setup, cfg, conv):
    f = setup["tail"]
    with_vd = cfg.get("do_vort_damp", False) and cfg.get("vtdm4", 0.0) > 0.0
    names = d_sw_tail_kernel.FIELDS
    return [conv(f[n]) if with_vd or not n.startswith("dv") else None for n in names]


@pytest.fixture(scope="module")
def tails(setup):
    out = {}
    for name, cfg in TAIL_CFGS.items():
        jargs = _tail_args(setup, cfg, jnp.asarray)
        targs = _tail_args(setup, cfg, _t)
        jcfg, tcfg = jd_sw.DSWConfig(**cfg), d_sw.DSWConfig(**cfg)
        out[name] = {
            "xla": jd_sw.d_sw_tail_jnp(*jargs, setup["jgrid"], DT, jcfg),
            "pallas": d_sw_tail_pallas(*jargs, setup["jgrid"], DT, jcfg, interpret=True),
            "plain": d_sw.d_sw_tail_plain(*targs, setup["tgrid"], DT, tcfg),
            "dispatched": d_sw.d_sw_tail(*targs, setup["tgrid"], DT, tcfg),
        }
    return out


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("idx", range(3), ids=TAIL_OUT)
@pytest.mark.parametrize("cfg", list(TAIL_CFGS))
def test_tail_matches(tails, cfg, idx, ref):
    got, want = tails[cfg]["plain"][idx], tails[cfg][ref][idx]
    if want is None:
        assert got is None and not d_sw.tracks_heat(d_sw.DSWConfig(**TAIL_CFGS[cfg]))
        return
    _close(got.numpy(), want, f"{cfg} {TAIL_OUT[idx]} vs {ref}")


@pytest.mark.parametrize("cfg", list(TAIL_CFGS))
def test_tail_cpu_tensors_take_the_plain_version(tails, cfg):
    for a, b in zip(tails[cfg]["plain"], tails[cfg]["dispatched"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert int((a != b).sum()) == 0, float((a - b).abs().max())


@pytest.mark.parametrize("cfg", ["bench", "divg_weights"])
def test_tail_cpu_result_does_not_depend_on_torch_sqrt(setup, cfg, monkeypatch):
    """The condition behind the unsteady ``[bench]`` comparison above: on the
    CPU ``torch.sqrt`` (MKL's vector math, split over OpenMP threads) once
    gave other bits for the same inputs within one process. Here it rounds
    every root one ulp up instead; the plain tail (the two configurations
    with the Smagorinsky term) must give the same bits as before."""
    targs = _tail_args(setup, TAIL_CFGS[cfg], _t)
    tcfg = d_sw.DSWConfig(**TAIL_CFGS[cfg])
    ref = d_sw.d_sw_tail_plain(*targs, setup["tgrid"], DT, tcfg)
    real_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.nextafter(
        real_sqrt(x), torch.full_like(x, float("inf"))))
    got = d_sw.d_sw_tail_plain(*targs, setup["tgrid"], DT, tcfg)
    for name, a, b in zip(TAIL_OUT, ref, got):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_ieee_sqrt_is_correctly_rounded(dtype):
    """Against numpy's IEEE square root, on values where MKL's high-accuracy
    root is an ulp off for about one in a hundred and thirty."""
    x = np.abs(np.random.default_rng(3).standard_normal(100_000)).astype(
        np.float32 if dtype == torch.float32 else np.float64) * 1e-10
    got = d_sw.ieee_sqrt(torch.from_numpy(x))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


def test_tail_kernel_rejects_cpu_tensors_and_bad_configs(setup):
    args = _tail_args(setup, BENCH, _t)
    with pytest.raises(ValueError, match="CUDA device"):
        d_sw_tail_kernel.d_sw_tail_cuda(*args, setup["tgrid"], DT, d_sw.DSWConfig(**BENCH))
    with pytest.raises(ValueError, match="nord 0..3"):
        d_sw_tail_kernel.d_sw_tail_cuda(*args, setup["tgrid"], DT, d_sw.DSWConfig(nord=4))
    with pytest.raises(ValueError, match="come together"):
        d_sw_tail_kernel.d_sw_tail_cuda(*args[:9], None, setup["tgrid"], DT,
                                        d_sw.DSWConfig(**BENCH))
    assert d_sw_tail_kernel.LAUNCHES["d_sw_tail"] == 0


def test_tail_kernel_parameters(setup):
    """The numbers the kernel is handed: the signed high-order coefficient
    and the band's del-2 coefficient, as the plain version's Python
    arithmetic forms them; the staggering tables cover every operand."""
    k = d_sw_tail_kernel
    da = setup["tgrid"].da_min_c
    for cfg in (d_sw.DSWConfig(**BENCH), d_sw.DSWConfig(**PLAIN)):
        dt, dddmp, da_min_c, dampn, dmin_edge = k.tail_params(cfg, DT, da)
        assert (dt, dddmp, da_min_c) == (DT, cfg.dddmp, da)
        assert dampn == cfg.d4_bg ** (cfg.nord + 1) * da * (-1.0) ** cfg.nord
        assert dmin_edge == da * max(cfg.d4_bg / 3.0, cfg.d2_bg)
    assert set(k._FIELD_STAGGER) == set(k.FIELDS)
    assert set(k._CONST_STAGGER) == set(k.CONSTS)
    S, Y, X = setup["tgrid"].area.shape
    for n, (dy, dx) in k._CONST_STAGGER.items():
        if hasattr(setup["tgrid"], n):
            assert tuple(getattr(setup["tgrid"], n).shape) == (S, Y + dy, X + dx), n
    for i, n in enumerate(k.EDGES):
        want = (S, Y + 1, 1) if i < 2 else (S, 1, X + 1)
        assert tuple(getattr(setup["tgrid"], n).shape) == want


# ---------------------------------------------------------------------------
# d_sw with the halo
# ---------------------------------------------------------------------------

D_SW_CASES = {
    "bench": (BENCH, True),
    "bench_no_w": (BENCH, False),
    "damp_w": (dict(BENCH, damp_w=0.05, hord_vt=8, hord_tm=5), True),
    "nord1": (PLAIN, True),
}


def _run_d_sw(mod, f, halo, grid, cfg, with_w, conv, patch_cls):
    u_y, v_x = halo.update_vector_fold_pair(conv(f["u"]), conv(f["v"]), kind="dgrid")
    scalars = [conv(f["delp"]), conv(f["pt"])] + ([conv(f["w"])] if with_w else [])
    pairs = halo.start_update_scalars_fold_patches(scalars).wait()
    (delp_x, delp_p), (pt_x, pt_p) = pairs[:2]
    w_x, w_y = (pairs[2][0], patch_cls(pairs[2][1])) if with_w else (None, None)
    uc, vc = halo.sync_vector_interfaces(conv(f["uc"]), conv(f["vc"]), kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    divg = halo.update_scalar(conv(f["divg_d"]), stagger="corner", fold="x")
    return mod.d_sw(u_y, v_x, w_x, delp_x, patch_cls(delp_p), pt_x, patch_cls(pt_p), w_x, w_y,
                    uc_x, vc_x, uc_y, vc_y, divg, grid, halo, DT, mod.DSWConfig(**cfg))


@pytest.fixture(scope="module")
def d_sw_results(setup):
    out = {}
    for name, (cfg, with_w) in D_SW_CASES.items():
        ref = _run_d_sw(jd_sw, setup["state"], setup["jhalo"], setup["jgrid"], cfg, with_w,
                        jnp.asarray, JCornerPatch)
        got = _run_d_sw(d_sw, setup["state"], setup["thalo"], setup["tgrid"], cfg, with_w,
                        _t, CornerPatch)
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("name", RESULT_FIELDS)
@pytest.mark.parametrize("case", list(D_SW_CASES))
def test_d_sw_matches(d_sw_results, case, name):
    ref, got = d_sw_results[case]
    want, have = getattr(ref, name), getattr(got, name)
    if want is None:
        assert have is None
        assert name == "w" and not D_SW_CASES[case][1] or name == "heat"
        return
    want = np.asarray(want)
    # the compute domain; interface fields keep the interfaces that bound it
    dy, dx = want.shape[-2] - (N + 2 * H), want.shape[-1] - (N + 2 * H)
    region = np.s_[..., H:H + N + dy, H:H + N + dx]
    _close(have.numpy(), want, f"{case} {name}", region)


def test_d_sw_conserves_mass_heat_and_w(d_sw_results, setup):
    """Flux form with synced interfaces: sum(delp area), sum(pt delp area) and
    sum(w delp area) over the sphere change by round-off only."""
    _ref, got = d_sw_results["bench"]
    i = np.s_[..., H:-H, H:-H]
    area = setup["tgrid"].area[i][:, None]
    f = {k: _t(v)[i] for k, v in setup["state"].items() if k in ("delp", "pt", "w")}
    m0, m1 = (f["delp"] * area).sum(), (got.delp[i] * area).sum()
    assert abs(float(m1 - m0)) <= 1e-13 * float(m0)
    for q0, q1 in ((f["pt"], got.pt[i]), (f["w"], got.w[i])):
        s0, s1 = (q0 * f["delp"] * area).sum(), (q1 * got.delp[i] * area).sum()
        scale = float((q0.abs() * f["delp"] * area).sum())
        assert abs(float(s1 - s0)) <= 1e-13 * scale

