"""The sim1, multi-field transport, tracer-block transport, single-field
transport, D-grid tail, C-grid tail, d2a2c, hydrostatic-chain and
updatedz_c kernels' CUDA sources, built for the CPU by
``tools/cuda_cpu_emulation.py`` and held against the plain versions, the
single-field kernel and earlier designs.

The card is not here; the emulation runs the kernels' own index arithmetic,
tiling, shared-memory passes and barriers on CPU tensors (see the tool's
docstring for what it cannot show). sim1: against ``ops.nonhydro.sim1_solver``
+ ``_p_fac_floor`` at K = 2 on a plane whose column count is no multiple of
the tile (float32 and float64), at K = 7 (32 columns a block), K = 79 (8)
and K = 200 (4) in float64, within rtol 1e-12 in float64 and 4 ulp of each
output's maximum in float32. ``logf`` rounds as the host's C library does,
not as ``torch.log`` on the CPU, and over many levels the cancelling
pressure difference amplifies that in float32: deep float32 columns are
held on the card (``chip_smoke.py``), not here. Multi-field transport:
equal to the single-field kernel built from the same source for every hord,
both y-fold forms and 1 to 4 fields, on a plane with interior and edge
tiles, and to the plain version on the consumed region. Tracer block: equal
to the single-field kernel tracer by tracer and to the same source's
one-block-per-tracer launch (``pace_fvtp2d_*`` with NQ tracers, the design
the tracer kernel replaced), and to the plain version on the consumed
region, for every hord, both y-fold forms and 1, 4 and 9 tracers on a plane
that is no multiple of the tile. D-grid tail: at C12, whose plane holds the
four cube corners of every tile, for nord 0 to 3 with every switch on and
with every switch off, equal to the plain version on the whole plane (on
the CPU both divide by three at the cube corners), and equal to the
design it replaced where the checkout's history holds it. Single-field
transport: for every hord, both y-fold forms and both weightings, equal to
the plain version on the consumed region and to the design it replaced
(700a797) on the whole plane, also with a block of three tracers. C-grid
tail: at C12, over a plane that holds cube corners and ten levels, equal to
the plain version (without the corner dedup, which the kernels skip) away
from the cube corners, and to its earlier tiling (700a797) on the whole
plane. updatedz_c: at 80, 79 and 2 layers on the main path's 198 x 198
plane and on a 5 x 37 plane, in float32 and float64, equal to the plain
version outside the outer ring and to the design before its redesign
(551ed44) on the whole plane.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pace_tpu_torch import constants
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import c_sw, d2a2c, d_sw, pgrad
from pace_tpu_torch.ops import c_sw_tail_kernel as ck
from pace_tpu_torch.ops import d2a2c_kernel as d2k
from pace_tpu_torch.ops import d_sw_tail_kernel as dtk
from pace_tpu_torch.ops import fvtp2d_kernel as fk
from pace_tpu_torch.ops import nonhydro
from pace_tpu_torch.ops.folds import CornerPatch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import cuda_cpu_emulation  # noqa: E402

P_, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the CPU emulation")
    out = tmp_path_factory.mktemp("emu")
    libs = {}
    for name in ("sim1", "fvtp2d", "d_sw_tail", "c_sw_tail", "d2a2c", "hydro", "updatedz"):
        path = cuda_cpu_emulation.build(ROOT / "pace_tpu_torch" / "csrc" / f"{name}.cu",
                                        out / f"lib{name}.so")
        libs[name] = ctypes.CDLL(str(path))
    for f in ("pace_sim1_f32", "pace_sim1_f64"):
        fn = getattr(libs["sim1"], f)
        fn.argtypes, fn.restype = [P_] * 6 + [D] * 6 + [P_] * 3 + [I] * 3 + [P_], I
    for f in ("pace_sim1_blend_f32", "pace_sim1_blend_f64"):
        fn = getattr(libs["sim1"], f)
        fn.argtypes, fn.restype = [P_] * 6 + [D] * 7 + [P_] * 3 + [I] * 3 + [P_], I
    for f in ("pace_fvtp2d_multi_f32", "pace_fvtp2d_multi_f64"):
        fn = getattr(libs["fvtp2d"], f)
        fn.argtypes, fn.restype = [P_, P_, I, I] + [P_] * 7 + [I] * 4 + [P_], I
    _fvtp2d_argtypes(libs["fvtp2d"])
    _d2a2c_argtypes(libs["d2a2c"])
    _hydro_argtypes(libs["hydro"])
    _updatedz_c_argtypes(libs["updatedz"])
    return libs


def _fvtp2d_argtypes(lib):
    for f in ("pace_fvtp2d_f32", "pace_fvtp2d_f64", "pace_fvtp2d_tracer_f32",
              "pace_fvtp2d_tracer_f64"):
        fn = getattr(lib, f, None)
        if fn is not None:
            fn.argtypes, fn.restype = [P_, P_, I, I] + [P_] * 9 + [I] * 6 + [P_], I


def _earlier_source(tmp_path_factory, rev, name):
    """``csrc/<name>.cu`` of revision ``rev`` built for the CPU, where the
    checkout's history holds it (skips otherwise)."""
    git = shutil.which("git")
    res = (subprocess.run([git, "-C", str(ROOT), "show", f"{rev}:pace_tpu_torch/csrc/{name}.cu"],
                          capture_output=True, text=True) if git else None)
    if res is None or res.returncode != 0:
        pytest.skip(f"the checkout's history does not hold {name}.cu of {rev}")
    out = tmp_path_factory.mktemp(f"emu_{name}_{rev}")
    src = out / f"{name}.cu"
    src.write_text(res.stdout)
    return ctypes.CDLL(str(cuda_cpu_emulation.build(src, out / f"lib{name}.so")))


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# ---------------------------------------------------------------- sim1


def _columns(S, K, Y, X, dtype, seed):
    """Random columns; in float32 ``delp`` on a 1/4 Pa lattice, where every
    partial sum is exact: the kernel sums in float32 in sequence, as
    ``torch.cumsum`` does on the card, but on the CPU ``torch.cumsum`` of a
    float32 tensor accumulates in float64."""
    rng = np.random.RandomState(seed)
    sh = (S, K, Y, X)
    delp = 50.0 + 100.0 * rng.rand(*sh)
    if dtype == torch.float32:
        delp = np.round(4.0 * delp) / 4.0
    arrays = (2.0 * rng.randn(*sh), -(20.0 + 400.0 * rng.rand(*sh)),
              270.0 + 40.0 * rng.rand(*sh), delp,
              0.3 + 0.5 * rng.rand(*sh), 0.5 * rng.randn(S, Y, X))
    return [torch.from_numpy(a).to(dtype).contiguous() for a in arrays]


def _sim1(lib, cols, dt, ptop, p_fac, a_imp=1.0):
    S, K, Y, X = cols[0].shape
    w_new, dz_new = torch.empty_like(cols[0]), torch.empty_like(cols[0])
    pp = torch.empty((S, K + 1, Y, X), dtype=cols[0].dtype)
    blend = (a_imp,) if a_imp != 1.0 else ()
    rc = getattr(lib, ("pace_sim1_blend_" if blend else "pace_sim1_") + _suffix(cols[0].dtype))(
        *[t.data_ptr() for t in cols], dt, ptop, p_fac, constants.GRAV, constants.RDGAS,
        1.0 / (1.0 - constants.KAPPA), *blend, w_new.data_ptr(), dz_new.data_ptr(),
        pp.data_ptr(), S, K, Y * X, None)
    assert rc == 0
    return w_new, dz_new, pp


@pytest.mark.parametrize("shape,dtype", [
    ((2, 2, 5, 37), torch.float64), ((2, 2, 5, 37), torch.float32),
    ((2, 7, 6, 9), torch.float64), ((1, 200, 3, 7), torch.float64),
    ((1, 79, 3, 11), torch.float64),
], ids=["K2-f64", "K2-f32", "K7-f64", "K200-f64", "K79-f64"])
@pytest.mark.parametrize("p_fac", [0.0, 2.0], ids=["no-floor", "floor-binds"])
def test_sim1_kernel_source_matches_the_plain_version(libs, shape, dtype, p_fac):
    _hold_sim1(libs, shape, dtype, p_fac, 1.0)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 2, 5, 37), torch.float64), ((2, 2, 5, 37), torch.float32),
    ((2, 7, 6, 9), torch.float64), ((2, 7, 6, 9), torch.float32),
    ((1, 79, 3, 11), torch.float64),
], ids=["K2-f64", "K2-f32", "K7-f64", "K7-f32", "K79-f64"])
@pytest.mark.parametrize("p_fac", [0.0, 2.0], ids=["no-floor", "floor-binds"])
def test_sim1_blend_kernel_source_matches_the_plain_version(libs, shape, dtype, p_fac):
    """The θ-blend instantiation (``pace_sim1_blend_*``) against
    ``sim1_solver(..., a_imp=0.75)``."""
    _hold_sim1(libs, shape, dtype, p_fac, 0.75)


def _hold_sim1(libs, shape, dtype, p_fac, a_imp):
    cols = _columns(*shape, dtype, seed=shape[1])
    dt, ptop = 4.0, 300.0
    got = _sim1(libs["sim1"], cols, dt, ptop, p_fac, a_imp)
    w_n, dz_n, pp_n = nonhydro.sim1_solver(*cols, dt, ptop, a_imp=a_imp)
    if p_fac > 0:
        dz_n = nonhydro._p_fac_floor(dz_n, *cols[2:5], ptop, p_fac)
    ulp = torch.finfo(dtype).eps
    for name, a, b in zip(("w", "delz", "pp"), got, (w_n, dz_n, pp_n)):
        scale = float(b.abs().max())
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)
        else:
            assert float((a - b).abs().max()) <= 4 * ulp * scale, name


# --------------------------------------------------- multi-field transport


def _operands(S, K, Y, X, dtype, seed):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a).to(dtype).contiguous()

    crx = t(np.round(rng.uniform(-0.9, 0.9, (S, K, Y, X + 1)), 2))
    cry = t(np.round(rng.uniform(-0.9, 0.9, (S, K, Y + 1, X)), 2))
    xfx = t(rng.uniform(-0.2, 0.2, (S, K, Y, X + 1)))
    yfx = t(rng.uniform(-0.2, 0.2, (S, K, Y + 1, X)))
    area = t(1.0 + rng.rand(S, Y, X))
    mfx, mfy = t(rng.randn(S, K, Y, X + 1)), t(rng.randn(S, K, Y + 1, X))
    return (crx, cry, xfx, yfx, area), mfx, mfy


def _field(S, K, Y, X, dtype, seed, patch, h=3):
    """Values with ties, zeros and negatives (hord 7's limiter acts)."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 6, size=(S, K, Y, X)).astype(np.float64)
    q += np.where(rng.rand(S, K, Y, X) < 0.5, 0.0, rng.randn(S, K, Y, X))
    qy = rng.randn(S, K, 2 * h, 2 * h) if patch else q + 0.1 * rng.randn(S, K, Y, X)
    qx, qy = (torch.from_numpy(a).to(dtype).contiguous() for a in (q, qy))
    return qx, (CornerPatch(qy) if patch else qy)


def _multi(lib, fields, ops, mfx, mfy):
    qx0 = fields[0][0]
    S, K, Y, X = qx0.shape
    ptrs, modes, outs, h = [], [], [], 0
    for qx, qy, hord, use_mf in fields:
        patch = isinstance(qy, CornerPatch)
        qy_t = qy.data if patch else qy
        h = qy_t.shape[-1] // 2 if patch else h
        fx = torch.full((S, K, Y, X + 1), 7.0, dtype=qx0.dtype)
        fy = torch.full((S, K, Y + 1, X), 7.0, dtype=qx0.dtype)
        outs.append((fx, fy))
        ptrs += [qx.data_ptr(), qy_t.data_ptr(), fx.data_ptr(), fy.data_ptr()]
        modes += [int(patch), hord, int(use_mf)]
    rc = getattr(lib, "pace_fvtp2d_multi_" + _suffix(qx0.dtype))(
        (P_ * len(ptrs))(*ptrs), (I * len(modes))(*modes), len(fields), h,
        *[t.data_ptr() for t in ops], mfx.data_ptr(), mfy.data_ptr(), S, K, Y, X, None)
    assert rc == 0
    return outs


def _single(lib, field, ops, mfx, mfy):
    qx, qy, hord, use_mf = field
    S, K, Y, X = qx.shape
    patch = isinstance(qy, CornerPatch)
    qy_t = qy.data if patch else qy
    fx = torch.full((S, K, Y, X + 1), 7.0, dtype=qx.dtype)
    fy = torch.full((S, K, Y + 1, X), 7.0, dtype=qx.dtype)
    rc = getattr(lib, "pace_fvtp2d_" + _suffix(qx.dtype))(
        qx.data_ptr(), qy_t.data_ptr(), int(patch), qy_t.shape[-1] // 2 if patch else 0,
        *[t.data_ptr() for t in ops], mfx.data_ptr() if use_mf else None,
        mfy.data_ptr() if use_mf else None, fx.data_ptr(), fy.data_ptr(), S, 1, K, Y, X, hord,
        None)
    assert rc == 0
    return fx, fy


CASES = {
    "dsw-trio": [(6, True, False), (6, False, True), (6, True, False)],
    "hydrostatic-pair": [(6, True, False), (6, False, True)],
    "mixed-four": [(8, False, False), (7, True, True), (1, False, False), (5, True, False)],
    "hord8": [(8, True, True)],
    "hord7-pair": [(7, False, False), (7, True, True)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_multi_kernel_source_equals_single_field_kernel_and_plain(libs, case, dtype):
    S, K, Y, X = 1, 1, 70, 70  # 15 tiles, 3 of them interior
    ops, mfx, mfy = _operands(S, K, Y, X, dtype, seed=len(CASES[case]))
    fields = []
    for n, (hord, use_mf, patch) in enumerate(CASES[case]):
        qx, qy = _field(S, K, Y, X, dtype, 10 * n + hord, patch)
        fields.append((qx, qy, hord, use_mf))
    got = _multi(libs["fvtp2d"], fields, ops, mfx, mfy)
    plain = fk.fvtp2d_multi_plain(fields, *ops, mfx=mfx, mfy=mfy)
    for field, (fx, fy), (px, py) in zip(fields, got, plain):
        sx, sy = _single(libs["fvtp2d"], field, ops, mfx, mfy)
        assert torch.equal(fx, sx) and torch.equal(fy, sy), field[2]
        for a, b in ((fx, px), (fy, py)):
            assert torch.equal(a[..., 3:-3, 3:-3], b[..., 3:-3, 3:-3]), field[2]


# ------------------------------------------------------ tracer-block transport


def _block(lib, entry, qx, qy, ops, mfx, mfy, hord):
    """``entry`` (``pace_fvtp2d`` or ``pace_fvtp2d_tracer``) on a tracer
    block ``(S, NQ, K, Y, X)``."""
    S, NQ, K, Y, X = qx.shape
    patch = isinstance(qy, CornerPatch)
    qy_t = qy.data if patch else qy
    fx = torch.full((S, NQ, K, Y, X + 1), 7.0, dtype=qx.dtype)
    fy = torch.full((S, NQ, K, Y + 1, X), 7.0, dtype=qx.dtype)
    rc = getattr(lib, f"{entry}_{_suffix(qx.dtype)}")(
        qx.data_ptr(), qy_t.data_ptr(), int(patch), qy_t.shape[-1] // 2 if patch else 0,
        *[t.data_ptr() for t in ops], mfx.data_ptr(), mfy.data_ptr(), fx.data_ptr(),
        fy.data_ptr(), S, NQ, K, Y, X, hord, None)
    assert rc == 0
    return fx, fy


TRACER_CASES = ([(hord, 4, patch) for hord in (1, 5, 6, 7, 8) for patch in (True, False)]
                + [(8, 1, True), (8, 9, True)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("hord,nq,patch", TRACER_CASES,
                         ids=[f"hord{h}-nq{n}-{'pack' if p else 'full'}"
                              for h, n, p in TRACER_CASES])
def test_tracer_kernel_source_equals_per_tracer_launches_and_plain(libs, hord, nq, patch,
                                                                   dtype):
    S, K, Y, X = 1, 1, 21, 45  # 2 x 2 tiles, both ragged
    ops, mfx, mfy = _operands(S, K, Y, X, dtype, seed=hord)
    qs = [_field(S, K, Y, X, dtype, 10 * t + hord, patch) for t in range(nq)]
    qx = torch.stack([q[0] for q in qs], dim=1).contiguous()
    qy_t = torch.stack([q[1].data if patch else q[1] for q in qs], dim=1).contiguous()
    qy = CornerPatch(qy_t) if patch else qy_t
    fx, fy = _block(libs["fvtp2d"], "pace_fvtp2d_tracer", qx, qy, ops, mfx, mfy, hord)
    # the one-block-per-tracer design, from the same source
    bx, by = _block(libs["fvtp2d"], "pace_fvtp2d", qx, qy, ops, mfx, mfy, hord)
    assert torch.equal(fx, bx) and torch.equal(fy, by)
    for t, (qx_t, qy_1) in enumerate(qs):
        sx, sy = _single(libs["fvtp2d"], (qx_t, qy_1, hord, True), ops, mfx, mfy)
        assert torch.equal(fx[:, t], sx) and torch.equal(fy[:, t], sy), t
    px, py = fk.fvtp2d_tracer_plain(qx, qy, *ops, mfx, mfy, hord)
    for a, b in ((fx, px), (fy, py)):
        assert torch.equal(a[..., 3:-3, 3:-3], b[..., 3:-3, 3:-3])


# ------------------------------------------------------------- D-grid tail

BENCH_TAIL = dict(nord=3, d4_bg=0.15, d2_bg=0.0, d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5,
                  do_vort_damp=True, vtdm4=0.06, d_con=1.0, edge_damp_band=True)
#: every switch on (the benchmark's set at each nord), every switch off
#: (no Smagorinsky part, band, vorticity damping or heat) and the
#: Laplacian's other weighting
TAIL_CASES = {f"nord{n}-{k}": cfg for n in range(4) for k, cfg in (
    ("all-on", dict(BENCH_TAIL, nord=n)),
    ("all-off", dict(BENCH_TAIL, nord=n, dddmp=0.0, edge_damp_band=False, vtdm4=0.0,
                     d_con=0.0)))}
TAIL_CASES["nord2-divg-weights"] = dict(BENCH_TAIL, nord=2, lap_divg_weights=True)


@pytest.fixture(scope="module")
def tail_setup():
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=(1, 1)))
    grids = {dt: GridData.from_metric_terms(mt, device="cpu", dtype=dt)
             for dt in (torch.float32, torch.float64)}
    S, Y, X = grids[torch.float64].area.shape
    rng = np.random.default_rng(13)
    K = 3  # the top two levels take the sponge's d2_col, the third d2_bg

    def r(dy, dx, scale=1.0):
        return scale * rng.standard_normal((S, K, Y + dy, X + dx))

    fields = dict(u=r(1, 0), v=r(0, 1), ut=r(0, 1), vt=r(1, 0), divg_d=r(1, 1, 1e-5),
                  vort=r(0, 0, 1e-5), vfx=r(0, 1), vfy=r(1, 0), dvfx=r(0, 1), dvfy=r(1, 0))
    return grids, fields


def _tail(fn, grid, fields, cfg, dtype):
    config = d_sw.DSWConfig(**cfg)
    with_vd = config.do_vort_damp and config.vtdm4 > 0.0
    args = [torch.from_numpy(fields[n]).to(dtype) if with_vd or not n.startswith("dv")
            else None for n in dtk.FIELDS]
    return args, config, dtk.call(dtk.set_argtypes(fn), args, grid, 200.0 / 56, config)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_kernel_source_equals_the_plain_version(libs, tail_setup, case, dtype):
    grids, fields = tail_setup
    cfg = TAIL_CASES[case]
    fn = getattr(libs["d_sw_tail"], f"pace_d_sw_tail_{_suffix(dtype)}")
    args, config, got = _tail(fn, grids[dtype], fields, cfg, dtype)
    ref = d_sw.d_sw_tail_plain(*args, grids[dtype], 200.0 / 56, config)
    assert grids[dtype].corner_table  # the plane holds cube corners
    for name, a, b in zip(("u_new", "v_new", "heat"), got, ref):
        assert (a is None) == (b is None), name
        if b is None:
            continue
        if config.nord == 0 and config.dddmp > 0.0:
            # the potential is the Smagorinsky part alone there, and the CPU's
            # plain version rounds it differently at a few points (the
            # design this kernel replaced did the same): 4 ulp of the maximum
            tol = 4 * torch.finfo(dtype).eps * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, name
        else:
            assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.fixture(scope="module")
def earlier_tail(libs, tmp_path_factory):
    """The D-grid tail source before its redesign, built for the CPU, where
    the checkout's history holds it."""
    return _earlier_source(tmp_path_factory, "3c5accc", "d_sw_tail")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["nord0-all-on", "nord1-all-off", "nord3-all-on"])
def test_tail_kernel_source_equals_the_earlier_design(libs, earlier_tail, tail_setup, case,
                                                      dtype):
    grids, fields = tail_setup
    name = f"pace_d_sw_tail_{_suffix(dtype)}"
    _a, _c, got = _tail(getattr(libs["d_sw_tail"], name), grids[dtype], fields,
                        TAIL_CASES[case], dtype)
    _a, _c, ref = _tail(getattr(earlier_tail, name), grids[dtype], fields, TAIL_CASES[case],
                        dtype)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------ single-field transport

#: (hord, corner pack, mass-flux weights, tracers): every hord in both y-fold
#: forms and both weightings, and two blocks of three tracers
SINGLE_CASES = ([(hord, patch, mf, 1) for hord in (1, 5, 6, 7, 8) for patch in (True, False)
                 for mf in (True, False)] + [(8, True, True, 3), (6, False, False, 3)])


@pytest.fixture(scope="module")
def earlier_fvtp2d(libs, tmp_path_factory):
    """The single-field transport's source before its redesign (700a797)."""
    lib = _earlier_source(tmp_path_factory, "700a797", "fvtp2d")
    _fvtp2d_argtypes(lib)
    return lib


def _single_block(lib, qx, qy, ops, mf, hord):
    """``pace_fvtp2d`` on a block ``(S, NQ, K, Y, X)``, area-flux weights
    unless ``mf`` (a pair of mass fluxes) is given."""
    S, NQ, K, Y, X = qx.shape
    patch = isinstance(qy, CornerPatch)
    qy_t = qy.data if patch else qy
    fx = torch.full((S, NQ, K, Y, X + 1), 7.0, dtype=qx.dtype)
    fy = torch.full((S, NQ, K, Y + 1, X), 7.0, dtype=qx.dtype)
    rc = getattr(lib, f"pace_fvtp2d_{_suffix(qx.dtype)}")(
        qx.data_ptr(), qy_t.data_ptr(), int(patch), qy_t.shape[-1] // 2 if patch else 0,
        *[t.data_ptr() for t in ops], *(t.data_ptr() if mf else None for t in mf or (0, 0)),
        fx.data_ptr(), fy.data_ptr(), S, NQ, K, Y, X, hord, None)
    assert rc == 0
    return fx, fy


def _single_inputs(K, dtype, hord, patch, nq):
    S, Y, X = 1, 19, 45  # 1 x 2 tiles of 20 x 40, both ragged
    ops, mfx, mfy = _operands(S, K, Y, X, dtype, seed=hord)
    qs = [_field(S, K, Y, X, dtype, 10 * t + hord, patch) for t in range(nq)]
    qx = torch.stack([q[0] for q in qs], dim=1).contiguous()
    qy_t = torch.stack([q[1].data if patch else q[1] for q in qs], dim=1).contiguous()
    return qx, (CornerPatch(qy_t) if patch else qy_t), ops, (mfx, mfy)


SINGLE_IDS = [f"hord{h}-{'pack' if p else 'full'}-{'mf' if m else 'area'}-nq{n}"
              for h, p, m, n in SINGLE_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("hord,patch,mf,nq", SINGLE_CASES, ids=SINGLE_IDS)
def test_single_field_kernel_source_equals_the_plain_version(libs, hord, patch, mf, nq, dtype):
    qx, qy, ops, mfs = _single_inputs(3, dtype, hord, patch, nq)
    fx, fy = _single_block(libs["fvtp2d"], qx, qy, ops, mfs if mf else None, hord)
    for t in range(nq):
        qy_1 = CornerPatch(qy.data[:, t]) if patch else qy[:, t]
        px, py = fk.fvtp2d_plain(qx[:, t], qy_1, *ops, hord, mfx=mfs[0] if mf else None,
                                 mfy=mfs[1] if mf else None)
        for a, b in ((fx[:, t], px), (fy[:, t], py)):
            assert torch.equal(a[..., 3:-3, 3:-3], b[..., 3:-3, 3:-3]), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("hord,patch,mf,nq", SINGLE_CASES, ids=SINGLE_IDS)
def test_single_field_kernel_source_equals_the_earlier_design(libs, earlier_fvtp2d, hord, patch,
                                                              mf, nq, dtype):
    """Against the design it replaced (a block per tile, level and tracer)
    on the whole plane, two levels."""
    qx, qy, ops, mfs = _single_inputs(2, dtype, hord, patch, nq)
    got = _single_block(libs["fvtp2d"], qx, qy, ops, mfs if mf else None, hord)
    ref = _single_block(earlier_fvtp2d, qx, qy, ops, mfs if mf else None, hord)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), int((a != b).sum())


# ------------------------------------------------------------- C-grid tail


@pytest.fixture(scope="module")
def c_tail_setup():
    """A C12 grid in both dtypes and random fields of the tail's 14
    operands, K = 10."""
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=(1, 1)))
    grids = {dt: GridData.from_metric_terms(mt, device="cpu", dtype=dt)
             for dt in (torch.float32, torch.float64)}
    S, Y, X = grids[torch.float64].area.shape
    rng = np.random.default_rng(5)
    scale = dict(delp=100.0, pt=300.0)
    fields = []
    for n in ck.FIELDS:
        dy, dx = ck._FIELD_STAGGER[n]
        a = rng.standard_normal((S, 10, Y + dy, X + dx))
        fields.append(scale[n] * (1.0 + 0.1 * a) if n in scale else a)
    return grids, fields


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_c_sw_tail_kernel_source_equals_the_plain_version(libs, c_tail_setup, dtype):
    grids, arrays = c_tail_setup
    grid = grids[dtype]
    fields = [torch.from_numpy(a).to(dtype) for a in arrays]
    name, dt2 = f"pace_c_sw_tail_{_suffix(dtype)}", 200.0 / 112
    got = ck.call(ck.set_argtypes(getattr(libs["c_sw_tail"], name)), fields, ck.constants(grid),
                  grid, dt2)
    plain = c_sw.c_sw_tail_plain(*fields, grid, dt2, dedup=False)
    assert grid.corner_table  # the plane holds cube corners
    for a, p in zip(got, plain):
        far = torch.ones(a.shape[-2:], dtype=torch.bool)
        for _kind, jj, ii, _own in grid.corner_table:
            far[max(jj - 1, 0):jj + 2, max(ii - 1, 0):ii + 2] = False
        assert torch.equal(a[..., far], p[..., far]), int((a[..., far] != p[..., far]).sum())


@pytest.fixture(scope="module")
def earlier_c_tail(libs, tmp_path_factory):
    """The C-grid tail's source before its retiling (700a797)."""
    return _earlier_source(tmp_path_factory, "700a797", "c_sw_tail")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_c_sw_tail_kernel_source_equals_the_earlier_design(libs, earlier_c_tail, c_tail_setup,
                                                           dtype):
    grids, arrays = c_tail_setup
    grid = grids[dtype]
    fields = [torch.from_numpy(a).to(dtype) for a in arrays]
    name, dt2 = f"pace_c_sw_tail_{_suffix(dtype)}", 200.0 / 112
    got, ref = (ck.call(ck.set_argtypes(getattr(lib, name)), fields, ck.constants(grid), grid, dt2)
                for lib in (libs["c_sw_tail"], earlier_c_tail))
    for a, b in zip(got, ref):
        assert torch.equal(a, b), int((a != b).sum())


# ------------------------------------------------------------------ d2a2c


def _d2a2c_argtypes(lib):
    for f in ("pace_d2a2c_f32", "pace_d2a2c_f64"):
        fn = getattr(lib, f)
        fn.argtypes, fn.restype = [P_, I, I, I, I, P_], I


def _d2a2c(lib, u, v, grid):
    """The kernel source's (ua, va, uc, vc, ut, vt), outputs NaN-filled first."""
    S, K, Y1, X = u.shape
    Y = Y1 - 1
    nan = lambda *sh: torch.full(sh, float("nan"), dtype=u.dtype)  # noqa: E731
    outs = (nan(S, K, Y, X), nan(S, K, Y, X), nan(S, K, Y, X + 1), nan(S, K, Y + 1, X),
            nan(S, K, Y, X + 1), nan(S, K, Y + 1, X))
    order = [u, v, *(getattr(grid, f).contiguous() for f in d2a2c.GRID_FIELDS), *outs]
    ptrs = (ctypes.c_void_p * len(order))(*(t.data_ptr() for t in order))
    assert getattr(lib, "pace_d2a2c_" + _suffix(u.dtype))(ptrs, S, K, Y, X, None) == 0
    return outs


@pytest.fixture(scope="module")
def d2a2c_setup():
    """Two planes in both dtypes: C12 (S = 6, 18 x 18 cells with the halo,
    the tile-edge band on every side, K = 30: two chunks of levels) and a
    19 x 45 plane (S = 2, K = 3) whose grid constants are random with a
    random band, neither a multiple of the kernel's 11 x 40 tile."""
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=(1, 1)))
    rng = np.random.default_rng(21)
    planes = {}
    for dtype in (torch.float32, torch.float64):
        c12 = GridData.from_metric_terms(mt, device="cpu", dtype=dtype)
        shapes = d2k.grid_shapes(2, 19, 45)
        rand = {f: torch.from_numpy(rng.standard_normal(sh)).to(dtype) for f, sh in shapes.items()}
        rand["band_c"] = torch.from_numpy((rng.random(shapes["band_c"]) < 0.3) * 1.0).to(dtype)
        planes[("C12", dtype)] = (c12, 30)
        planes[("19x45", dtype)] = (SimpleNamespace(**rand), 3)
    winds = {}
    for (name, dtype), (grid, K) in planes.items():
        S, Y, X = grid.band_c.shape
        u = rng.standard_normal((S, K, Y + 1, X))
        v = rng.standard_normal((S, K, Y, X + 1))
        winds[(name, dtype)] = (torch.from_numpy(10 * u).to(dtype),
                                torch.from_numpy(10 * v).to(dtype), grid)
    return winds


D2A2C_CASES = [(n, d) for n in ("C12", "19x45") for d in (torch.float32, torch.float64)]
D2A2C_IDS = [f"{n}-{_suffix(d)}" for n, d in D2A2C_CASES]


@pytest.mark.parametrize("plane,dtype", D2A2C_CASES, ids=D2A2C_IDS)
def test_d2a2c_kernel_source_matches_the_plain_version(libs, d2a2c_setup, plane, dtype):
    """Bit-identical on the rings a consumer reads: ua, va on the whole
    plane, uc, vc without their outer two rings, ut, vt without three."""
    u, v, grid = d2a2c_setup[(plane, dtype)]
    got = _d2a2c(libs["d2a2c"], u, v, grid)
    plain = d2a2c.d2a2c_plain(u, v, grid)
    if plane == "C12":
        assert bool((grid.band_c > 0.5).any()) and bool((grid.band_c < 0.5).any())
    for name, a, b, r in zip(("ua", "va", "uc", "vc", "ut", "vt"), got, plain,
                             (0, 0, 2, 2, 3, 3)):
        a, b = a[..., r:a.shape[-2] - r, r:a.shape[-1] - r], b[..., r:b.shape[-2] - r,
                                                              r:b.shape[-1] - r]
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.fixture(scope="module")
def earlier_d2a2c(libs, tmp_path_factory):
    """d2a2c's source before its retiling (48d33f4)."""
    lib = _earlier_source(tmp_path_factory, "48d33f4", "d2a2c")
    _d2a2c_argtypes(lib)
    return lib


@pytest.mark.parametrize("plane,dtype", D2A2C_CASES, ids=D2A2C_IDS)
def test_d2a2c_kernel_source_equals_the_earlier_design(libs, earlier_d2a2c, d2a2c_setup, plane,
                                                      dtype):
    u, v, grid = d2a2c_setup[(plane, dtype)]
    got = _d2a2c(libs["d2a2c"], u, v, grid)
    ref = _d2a2c(earlier_d2a2c, u, v, grid)
    for a, b in zip(got, ref):  # every point written (no NaN left) and equal
        assert torch.equal(a, b), int((a != b).sum())


# ------------------------------------------------------------------ hydro

HYDRO_ALL = ("pe", "peln", "pk", "pkz", "gz")
#: every form the model asks for: the nonhydrostatic step's two, the
#: hydrostatic step's two, and all five outputs
HYDRO_NEEDS = (("pkz",), ("pk", "pkz"), ("pk", "pkz", "gz"), ("pk", "gz"), HYDRO_ALL)
HYDRO_CASES = [(K, d, need) for K in (2, 79) for d in (torch.float32, torch.float64)
               for need in HYDRO_NEEDS]
HYDRO_IDS = [f"K{K}-{_suffix(d)}-{'+'.join(need)}" for K, d, need in HYDRO_CASES]


def _hydro_argtypes(lib):
    for f in ("pace_hydro_f32", "pace_hydro_f64"):
        fn = getattr(lib, f)
        fn.argtypes, fn.restype = [P_, P_, P_, D, D, D, D, P_, P_, P_, P_, P_, I, I, I, P_], I


def _hydro_columns(K, dtype):
    """delp, pt (2, K, 7, 45) and phis: 630 columns, no multiple of the
    kernel's blocks; in float32 delp on a 1/4 Pa lattice (see _columns)."""
    rng = np.random.RandomState(K)
    sh = (2, K, 7, 45)
    delp = 50.0 + 100.0 * rng.rand(*sh) + (1e5 / K if K < 10 else 0.0)
    delp = np.round(4.0 * delp) / 4.0
    arrays = (delp, 250.0 + 60.0 * rng.rand(*sh), 500.0 * rng.randn(2, 7, 45))
    return [torch.from_numpy(a).to(dtype).contiguous() for a in arrays]


def _hydro(lib, delp, pt, phis, ptop, need):
    S, K, Y, X = delp.shape
    outs = {n: torch.full((S, K if n == "pkz" else K + 1, Y, X), float("nan"), dtype=delp.dtype)
            for n in need}
    rc = getattr(lib, "pace_hydro_" + _suffix(delp.dtype))(
        delp.data_ptr(), pt.data_ptr(), phis.data_ptr(), ptop, constants.P_REF,
        constants.KAPPA, constants.CP_AIR, *(outs[n].data_ptr() if n in outs else None
                                             for n in HYDRO_ALL), S, K, Y * X, None)
    assert rc == 0
    return outs


@pytest.mark.parametrize("K,dtype,need", HYDRO_CASES, ids=HYDRO_IDS)
def test_hydro_kernel_source_matches_the_plain_version(libs, K, dtype, need):
    """Each output asked for, against the plain version evaluated in float64
    on the same inputs: in float64 within 1e-12 of each output's maximum; in
    float32 within twice the plain float32 version's own error plus 2 ulp of
    the maximum (chip_smoke.py's yardstick: logf and powf round here as the
    host's C library does, torch.log and torch.pow otherwise)."""
    delp, pt, phis = _hydro_columns(K, dtype)
    ptop = 300.0
    got = _hydro(libs["hydro"], delp, pt, phis, ptop, need)
    plain = dict(zip(HYDRO_ALL, pgrad.hydrostatic_interfaces(delp, pt, phis, ptop)))
    truth = dict(zip(HYDRO_ALL, pgrad.hydrostatic_interfaces(delp.double(), pt.double(),
                                                             phis.double(), ptop)))
    ulp = torch.finfo(dtype).eps
    for name in need:
        a, scale = got[name].double(), float(truth[name].abs().max())
        err = float((a - truth[name]).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-12 * scale, (name, err, scale)
        else:
            e_plain = float((plain[name].double() - truth[name]).abs().max())
            assert err <= 2 * e_plain + 2 * ulp * scale, (name, err, e_plain, scale)


@pytest.fixture(scope="module")
def earlier_hydro(libs, tmp_path_factory):
    """The hydrostatic chain's source before its redesign (48d33f4)."""
    lib = _earlier_source(tmp_path_factory, "48d33f4", "hydro")
    _hydro_argtypes(lib)
    return lib


@pytest.mark.parametrize("K,dtype,need", HYDRO_CASES, ids=HYDRO_IDS)
def test_hydro_kernel_source_equals_the_earlier_design(libs, earlier_hydro, K, dtype, need):
    delp, pt, phis = _hydro_columns(K, dtype)
    got = _hydro(libs["hydro"], delp, pt, phis, 300.0, need)
    ref = _hydro(earlier_hydro, delp, pt, phis, 300.0, need)
    for name in need:
        assert torch.equal(got[name], ref[name]), (name, int((got[name] != ref[name]).sum()))


# ------------------------------------------------------------- updatedz_c

#: layers (80 and 79: two chunks of interfaces a column, the second holding
#: the bottom interface alone, and the main path's one chunk; 2) by plane
#: (198 x 198, the main path's, S = 1; 5 x 37, S = 2: no multiple of a block)
UZ_CASES = [(K, plane, d) for K in (80, 79, 2) for plane in ((1, 198, 198), (2, 5, 37))
            for d in (torch.float32, torch.float64)]
UZ_IDS = [f"K{K}-{plane[1]}x{plane[2]}-{_suffix(d)}" for K, plane, d in UZ_CASES]


def _updatedz_c_argtypes(lib):
    for f in ("pace_updatedz_c_f32", "pace_updatedz_c_f64"):
        fn = getattr(lib, f)
        fn.argtypes, fn.restype = [P_] * 5 + [D, P_, P_] + [I] * 4 + [P_], I


def _updatedz_c_operands(K, plane, dtype):
    """Interface heights decreasing downward (both folds), layer area fluxes
    of both signs and cell areas, from a seed."""
    S, Y, X = plane
    rng = np.random.default_rng(K + Y)
    zh = 100.0 * np.cumsum(rng.random((S, K + 1, Y, X))[:, ::-1], axis=1)[:, ::-1]
    arrays = (zh, zh + rng.standard_normal(zh.shape), 1e3 * rng.standard_normal((S, K, Y, X + 1)),
              1e3 * rng.standard_normal((S, K, Y + 1, X)), 1e4 + 1e3 * rng.random((S, Y, X)))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


def _updatedz_c(lib, args, dt2):
    """``(zh_new, ws)`` of the source in ``lib``; NaN where it writes nothing."""
    zh_x = args[0]
    S, K1, Y, X = zh_x.shape
    out = torch.full_like(zh_x, float("nan"))
    ws = torch.full((S, Y, X), float("nan"), dtype=zh_x.dtype)
    rc = getattr(lib, "pace_updatedz_c_" + _suffix(zh_x.dtype))(
        *(t.data_ptr() for t in args), dt2, out.data_ptr(), ws.data_ptr(), S, K1 - 1, Y, X, None)
    assert rc == 0
    return out, ws


@pytest.mark.parametrize("K,plane,dtype", UZ_CASES, ids=UZ_IDS)
def test_updatedz_c_kernel_source_matches_the_plain_version(libs, K, plane, dtype):
    """Bit-identical outside the outer ring, the region chip_smoke.py gates
    (the outermost ring is unspecified)."""
    args = _updatedz_c_operands(K, plane, dtype)
    got = _updatedz_c(libs["updatedz"], args, 3.5)
    plain = nonhydro.updatedz_c_plain(*args, 3.5)
    for name, a, b in zip(("zh", "ws"), got, plain):
        a, b = a[..., 1:-1, 1:-1], b[..., 1:-1, 1:-1]
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.fixture(scope="module")
def earlier_updatedz(libs, tmp_path_factory):
    """updatedz.cu before updatedz_c's redesign (551ed44)."""
    lib = _earlier_source(tmp_path_factory, "551ed44", "updatedz")
    _updatedz_c_argtypes(lib)
    return lib


@pytest.mark.parametrize("K,plane,dtype", UZ_CASES, ids=UZ_IDS)
def test_updatedz_c_kernel_source_equals_the_earlier_design(libs, earlier_updatedz, K, plane,
                                                           dtype):
    args = _updatedz_c_operands(K, plane, dtype)
    got = _updatedz_c(libs["updatedz"], args, 3.5)
    ref = _updatedz_c(earlier_updatedz, args, 3.5)
    for name, a, b in zip(("zh", "ws"), got, ref):  # every point written and equal
        assert torch.equal(a, b), (name, int((a != b).sum()))


# ------------------------------------------ the tuning candidates' tables

@pytest.mark.parametrize("name", ["sim1", "fvtp2d", "tracer", "d_sw_tail", "single",
                                  "c_sw_tail", "d2a2c", "hydro", "updatedz_c"])
def test_variant_candidates_apply_to_the_current_sources(name):
    """Every candidate and diagnostic of tools/torch_kernel_variants.py
    finds its text in the current source and changes it (the tool raises
    on the card otherwise, after the first builds have started)."""
    import torch_kernel_variants

    src = (ROOT / "pace_tpu_torch" / "csrc" / f"{torch_kernel_variants.LIBRARY.get(name, name)}.cu"
           ).read_text()
    texts = torch_kernel_variants.candidate_sources(name)
    assert texts and all(text != src for text in texts.values())


def test_earlier_updatedz_c_diagnostics_apply_to_its_source(tmp_path):
    """tools/torch_kernel_variants.py's EARLIER diagnostics of updatedz_c
    find their texts in 551ed44's source (``--prev`` raises otherwise)."""
    import torch_kernel_variants

    git = shutil.which("git")
    res = (subprocess.run([git, "-C", str(ROOT), "show", "551ed44:pace_tpu_torch/csrc/updatedz.cu"],
                          capture_output=True, text=True) if git else None)
    if res is None or res.returncode != 0:
        pytest.skip("the checkout's history does not hold updatedz.cu of 551ed44")
    (tmp_path / "updatedz.cu").write_text(res.stdout)
    texts = torch_kernel_variants.earlier_sources("updatedz_c", tmp_path)
    assert len(texts) == 3 and sum(text == res.stdout for text in texts.values()) == 1
