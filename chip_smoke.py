#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pace_tpu_torch``) on one NVIDIA card.

Run from the repository root::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build: compile every CUDA kernel of ``pace_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, all started together);
2. kernel checks: each kernel against its plain PyTorch version on the card,
   at the shapes of the two slices at C192, npz=79, f32 (nq=9 tracers), with
   kernel, plain-version and one-call library times. Transport slice: the
   halo exactly, fvtp2d within 4 ulp of max|flux| on the consumed region.
   C-grid slice: the new halo plans exactly; d2a2c and the c_sw tail within
   4 ulp of each output's maximum (d2a2c on the rings a consumer reads); the
   hydrostatic chain, whose sums and cancelling differences amplify
   rounding, within three times the plain version's own float32 error,
   measured against its float64 evaluation (see ``check_against_f64``);
3. small-input references in float64, kernel path on the card against the
   plain path on the CPU: the tracer-advection demo at C24 and the C-grid
   half step at C24, within 1e-12;
4. the slices through their user entry points, each with every launch
   counter set to 0 just before and read just after: the tracer-advection
   demo at C192, npz=79, nq=9, f32, dt=1800 s, 6 steps (conservation,
   monotonicity, finiteness), and the C-grid half of an acoustic substep
   from the baroclinic-wave state at C192, npz=79, f32, 4 repeats
   (finiteness, positivity and conservation of delpc, range of ptc and pkz,
   and the balance of the unperturbed state);
5. where the time goes: two more steps of each demo under
   ``torch.profiler``, device time by kernel.

The last lines are the card's name and power limit (``nvidia-smi``), the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet) at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12

N, NPZ, NQ, DT, STEPS = 192, 79, 9, 1800.0, 6

# Floating-point operations (add, sub, mul, div, min, max, abs, negate,
# compare) per output point that the fvtp2d scheme needs, with each per-cell
# PPM term computed once per cell (the kernel recomputes some of them for
# each interface; that redundancy is not counted). One 1-D PPM evaluation:
#   hord 6: interface value al 5, perturbations bl/br 2, b0 1, upwind value 6
#           = 14;
#   hord 8: mono slope dm 12, al 5, limited bl/br 10, b0 1, upwind value 6
#           = 34.
# Four evaluations per point, two inner updates (7 each) and the two
# weighted results (3 each).
FVTP2D_OPS_PER_POINT = {6: 4 * 14 + 20, 8: 4 * 34 + 20}


# Operations per output point (cell and level) of the C-grid kernels, on
# the interior path (the tile-edge band of d2a2c does 21 more):
#   d2a2c: D->A averages 10, contravariant pair 6, Cartesian vector 9, its
#          two projections 10, ua/va 6, interpolation and projection to each
#          interface 20 + 20, contravariant C winds 7 + 7 = 95;
#   c_sw tail: ut/vt 14, area fluxes 8, upwind fluxes 6, delpc 5, ptc 7,
#          ke 6, vorticity 9, uc_new/vc_new 25, divergence legs 14, corner
#          outflow 4 = 98;
#   hydro: per level and column, the two running sums 4, log and pow 1 each,
#          pe/p_ref 1, dpk and dpeln 2, pkz 2, the gz contribution 2 = 13.
D2A2C_OPS_PER_POINT = 95
C_SW_TAIL_OPS_PER_POINT = 98
HYDRO_OPS_PER_POINT = 13

#: acceptance threshold of the balance check: rms C-grid wind tendency of the
#: unperturbed baroclinic state over rms pressure-gradient term. The demo on
#: the CPU in float64, where it equals pace_tpu to 1e-12, gives 0.0517 at C24
#: and 0.0563 at C48 (``cgrid_half_step --npz 79 --device cpu --f64``); the
#: ratio grows slowly with resolution, and a missing or wrong term gives O(1)
BALANCE_RATIO_MAX = 0.15


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` calls, after one warm-up call
    (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, ops, dtype):
    """(bound ms, what bounds it) at the card's published peaks."""
    peak_ops = PEAK_F32_OPS_PER_S if dtype == torch.float32 else PEAK_F64_OPS_PER_S
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ring(t, r):
    """``t`` without its outer ``r`` rows and columns."""
    return t[..., r:t.shape[-2] - r, r:t.shape[-1] - r] if r else t


def check_close(label, got, ref, tol_abs):
    """Max abs error of ``got`` against ``ref``; raises beyond ``tol_abs``."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"[check] {label}: max abs err {err:.3e} (max|ref| {scale:.3e}, "
        f"tolerance {tol_abs:.3e})")
    if not err <= tol_abs:
        raise AssertionError(f"{label}: max abs err {err} beyond {tol_abs}")
    return err


def check_against_f64(label, got, plain, truth, ulp):
    """Hold a float32 kernel result against its plain version where rounding
    is amplified (sums of K terms, cancelling differences): ``truth`` is the
    plain version evaluated in float64 on the same inputs, and the plain
    float32 version's own error against it, ``e_plain``, is the yardstick.
    The kernel must be within ``2 e_plain + 2 ulp max|truth|`` of the truth,
    hence within ``3 e_plain + 2 ulp max|truth|`` of the plain float32
    version. Returns the max abs error against the plain version."""
    scale = float(truth.abs().max())
    e_plain = float((plain.double() - truth).abs().max())
    e_kernel = float((got.double() - truth).abs().max())
    err = float((got - plain).abs().max())
    floor = 2 * ulp * scale
    log(f"[check] {label}: max abs err {err:.3e} vs the plain version (tolerance "
        f"{3 * e_plain + floor:.3e}); vs float64: kernel {e_kernel:.3e}, plain {e_plain:.3e} "
        f"(tolerance {2 * e_plain + floor:.3e}); max|ref| {scale:.3e}")
    if not (e_kernel <= 2 * e_plain + floor and err <= 3 * e_plain + floor):
        raise AssertionError(f"{label}: kernel err {e_kernel} vs float64, {err} vs plain, "
                             f"plain's own {e_plain}")
    return err


def profile_steps(label, step_fn, wall_ms):
    """Two calls of ``step_fn`` under torch.profiler: device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step_fn()
        torch.cuda.synchronize()
    # device-side kernel events only: the host-side operator events carry
    # their kernels' time too
    rows = [(e.key, e.self_device_time_total / 2e3, e.count // 2)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy > 0:
        log(f"[profile] {label}: device time per step {busy:.3f} ms of {wall_ms:.3f} ms "
            f"wall (busy share {busy / wall_ms:.3f})")
        for name, t, n_calls in rows[:10]:
            log(f"[profile] {t:9.3f} ms {100 * t / busy:5.1f}% x{n_calls:<3d} {name[:90]}")
    else:
        log(f"[profile] {label}: the profiler recorded no device time: not measured")


def consumed(t):
    """The consumed region of an interface flux: all but the outer 3 rows
    and columns (the never-consumed outermost ring and the stencil wrap)."""
    return ring(t, 3)


def main(device="cuda:0", n=N, npz=NPZ, nq=NQ, steps=STEPS) -> int:
    """The run described above; the arguments exist to rehearse the script
    at a small size, and the card is always required."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pace_tpu_torch import _build
    from pace_tpu_torch.demos import cgrid_half_step as cdemo
    from pace_tpu_torch.demos import tracer_advection as demo
    from pace_tpu_torch.ops import c_sw as c_sw_ops
    from pace_tpu_torch.ops import c_sw_tail_kernel as ck
    from pace_tpu_torch.ops import d2a2c as d2a2c_ops
    from pace_tpu_torch.ops import d2a2c_kernel as d2k
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops import hydro_kernel as hyk
    from pace_tpu_torch.ops import pgrad as pgrad_ops
    from pace_tpu_torch.ops.folds import CornerPatch
    from pace_tpu_torch.ops.fvtp2d import fvtp2d_best
    from pace_tpu_torch.ops.stencil_utils import bcast_k, x_iface_diff, y_iface_diff
    from pace_tpu_torch.ops.tracer_advection import subcycle_count
    from pace_tpu_torch.parallel import halo_kernel as hk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ------------------------------------------------------------------
    # 1. build
    # ------------------------------------------------------------------
    t0 = time.perf_counter()
    times = _build.build()
    log(f"[build] {sorted(_build.SOURCES)} for sm_90a in {time.perf_counter() - t0:.1f} s "
        f"(per library: {', '.join(f'{k} {v:.1f} s' for k, v in sorted(times.items()))})")
    for name, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ------------------------------------------------------------------
    # 2. kernel checks at the slice's full shapes
    # ------------------------------------------------------------------
    t0 = time.perf_counter()
    case = demo.build_case(n, npz, nq, DT, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"[case] C{n} npz={npz} nq={nq} grid, halo and inputs built in "
        f"{time.perf_counter() - t0:.1f} s")
    slabs = case.halo.slabs
    grid = case.grid
    n_sub = subcycle_count(case.crx, case.cry, grid.n_halo)
    frac = 1.0 / n_sub
    crx, cry, xfx, yfx = (case.crx * frac, case.cry * frac, case.xfx * frac, case.yfx * frac)
    delp = case.delp
    q = case.q  # (S, nq, K, Y, X)
    results = {}

    # --- halo: every plan of the slice, on a field and on the tracer block
    dpx, dpp = case.halo.update_scalar_fold_patch(delp)
    fl = fvtp2d_best(dpx, CornerPatch(dpp), case.crx, case.cry, case.xfx, case.yfx,
                     grid.area, 6)
    mfx, mfy = case.halo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    mfx, mfy = mfx * frac, mfy * frac
    fxq = torch.randn((q.shape[0], nq, npz) + tuple(mfx.shape[-2:]), device=dev)
    fyq = torch.randn((q.shape[0], nq, npz) + tuple(mfy.shape[-2:]), device=dev)
    halo_cases = [
        ("scalar x-fold", slabs.scalar_plan("center", "x"), {"q": delp}),
        ("fold patch", slabs.fold_patch_plan("center"), {"q": delp}),
        ("cgrid sync", slabs.sync_plan("cgrid"), {"u": fl.fx, "v": fl.fy}),
        ("scalar x-fold", slabs.scalar_plan("center", "x"), {"q": q}),
        ("fold patch", slabs.fold_patch_plan("center"), {"q": q}),
        ("cgrid sync", slabs.sync_plan("cgrid"), {"u": fxq, "v": fyq}),
    ]
    halo_err = 0.0
    for label, plan, inputs in halo_cases:
        lifted = {k: hk._lift(v) for k, v in inputs.items()}
        got = hk.halo_cuda(lifted, plan)
        ref = hk.halo_plain(lifted, plan)
        torch.cuda.synchronize()
        for name in ref:
            err = float((got[name] - ref[name]).abs().max())
            if not torch.equal(got[name], ref[name]):
                raise AssertionError(f"halo {label} output {name}: max abs err {err}")
            halo_err = max(halo_err, err)
        shapes = " ".join(str(tuple(v.shape)) for v in inputs.values())
        log(f"[check] halo {label} {shapes}: exact")

    # timed at the largest main-path call: the tracer block's fold patch
    plan = slabs.fold_patch_plan("center")
    lifted = {"q": hk._lift(q)}
    ms = time_ms(lambda: hk.halo_cuda(lifted, plan), 20)
    plain_ms = time_ms(lambda: hk.halo_plain(lifted, plan), 5)
    # one-call yardstick: a single torch.take with the same per-point map
    # (expanded over the levels; no sign flip, which this plan does not need)
    planes = {"q": tuple(lifted["q"].shape[-2:])}
    S, K = lifted["q"].shape[:2]
    take_idx = []
    for name, src, shape in plan.outputs:
        off, meta = (torch.from_numpy(m).to(dev, torch.int64)
                     for m in hk.index_map(plan, name, planes, S))
        P_in = planes["q"][0] * planes["q"][1]
        g = (meta >> 2) * (K * P_in) + off  # (S, Yo, Xo), level 0
        lev = torch.arange(K, device=dev).view(1, K, 1, 1) * P_in
        take_idx.append((g[:, None] + lev).contiguous())
    src_flat = lifted["q"]
    ref = hk.halo_plain(lifted, plan)
    for (name, _, _), idx in zip(plan.outputs, take_idx):
        if not torch.equal(torch.take(src_flat, idx), ref[name]):
            raise AssertionError(f"torch.take yardstick disagrees on halo output {name}")
    library_ms = time_ms(lambda: [torch.take(src_flat, i) for i in take_idx], 20)
    Yo, Xo = planes["q"]
    h = grid.n_halo
    map_bytes = 8 * S * (Yo * Xo + 4 * h * h)
    halo_bytes = 2 * nbytes(src_flat) + S * K * 4 * h * h * 4 + map_bytes
    b_ms, b_by = bound(halo_bytes, 0, torch.float32)
    results["halo"] = dict(max_abs_err=halo_err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    log(f"[time] halo fold patch {tuple(src_flat.shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.take {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # --- fvtp2d, one field (delp), hord 6 and 8, area-flux weights
    ulp = torch.finfo(torch.float32).eps
    fv_err = 0.0
    for hord in (6, 8):
        fx, fy = fk.fvtp2d_cuda(dpx, CornerPatch(dpp), crx, cry, xfx, yfx, grid.area, hord)
        rx, ry = fk.fvtp2d_plain(dpx, CornerPatch(dpp), crx, cry, xfx, yfx, grid.area, hord)
        torch.cuda.synchronize()
        for nm, a, b in (("fx", fx, rx), ("fy", fy, ry)):
            a, b = consumed(a), consumed(b)
            err = (a - b).abs()
            scale = float(b.abs().max())
            tol = 4 * ulp * scale
            n_bad = int((err > tol).sum())
            e = float(err.max())
            log(f"[check] fvtp2d hord {hord} {nm}: max abs err {e:.3e}, max rel err "
                f"{e / scale:.3e} of max|flux| {scale:.3e}, points beyond 4 ulp: {n_bad}")
            if n_bad:
                raise AssertionError(f"fvtp2d hord {hord} {nm}: {n_bad} points beyond 4 ulp")
            fv_err = max(fv_err, e)
        if hord == 6:
            args = (dpx, CornerPatch(dpp), crx, cry, xfx, yfx, grid.area, hord)
            ms = time_ms(lambda: fk.fvtp2d_cuda(*args), 20)
            plain_ms = time_ms(lambda: fk.fvtp2d_plain(*args), 3)
            byt = nbytes(dpx, dpp, crx, cry, xfx, yfx, grid.area, fx, fy)
            b_ms, b_by = bound(byt, FVTP2D_OPS_PER_POINT[hord] * dpx.numel(), torch.float32)
            results["fvtp2d"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None)
            log(f"[time] fvtp2d hord 6 {tuple(dpx.shape)} f32: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["fvtp2d"]["max_abs_err"] = fv_err

    # --- fvtp2d tracer block, nq=9, hord 8, mass-flux weights
    qx, qp = case.halo.update_scalar_fold_patch(q)
    targs = (qx, CornerPatch(qp), crx, cry, xfx, yfx, grid.area, mfx, mfy, 8)
    fx, fy = fk.fvtp2d_tracer_cuda(*targs)
    rx, ry = fk.fvtp2d_tracer_plain(*targs)
    torch.cuda.synchronize()
    tr_err = 0.0
    for nm, a, b in (("fx", fx, rx), ("fy", fy, ry)):
        a, b = consumed(a), consumed(b)
        err = (a - b).abs()
        scale = float(b.abs().max())
        n_bad = int((err > 4 * ulp * scale).sum())
        e = float(err.max())
        log(f"[check] fvtp2d tracer nq={nq} hord 8 {nm}: max abs err {e:.3e}, max rel err "
            f"{e / scale:.3e} of max|flux| {scale:.3e}, points beyond 4 ulp: {n_bad}")
        if n_bad:
            raise AssertionError(f"fvtp2d tracer {nm}: {n_bad} points beyond 4 ulp")
        tr_err = max(tr_err, e)
    ms = time_ms(lambda: fk.fvtp2d_tracer_cuda(*targs), 10)
    plain_ms = time_ms(lambda: fk.fvtp2d_tracer_plain(*targs), 2)
    byt = nbytes(qx, qp, crx, cry, xfx, yfx, grid.area, mfx, mfy, fx, fy)
    b_ms, b_by = bound(byt, FVTP2D_OPS_PER_POINT[8] * qx.numel(), torch.float32)
    results["fvtp2d_tracer"] = dict(max_abs_err=tr_err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] fvtp2d tracer hord 8 {tuple(qx.shape)} f32: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del fx, fy, rx, ry, fxq, fyq, take_idx, qx, qp

    # --- one step, kernel path against the plain path on the card
    def plain_exchange(inputs, plan):
        lead = tuple(next(iter(inputs.values())).shape[:-2])
        outs = hk.halo_plain({k: hk._lift(v) for k, v in inputs.items()}, plan)
        return {k: v.reshape(lead + tuple(v.shape[-2:])) for k, v in outs.items()}

    def plain_step(case, q, dp1):
        o = plain_exchange({"q": dp1}, slabs.fold_patch_plan("center"))
        fx, fy = fk.fvtp2d_plain(o["qx"], CornerPatch(o["qp"]), case.crx, case.cry,
                                 case.xfx, case.yfx, grid.area, 6)
        o = plain_exchange({"u": fx, "v": fy}, slabs.sync_plan("cgrid"))
        n = subcycle_count(case.crx, case.cry, grid.n_halo)
        f = 1.0 / n
        c = [t * f for t in (case.crx, case.cry, case.xfx, case.yfx, o["u"], o["v"])]
        for _ in range(n):
            dp2 = dp1 + (x_iface_diff(c[4]) + y_iface_diff(c[5])) * bcast_k(grid.rarea, dp1)
            p = plain_exchange({"q": q}, slabs.fold_patch_plan("center"))
            fx, fy = fk.fvtp2d_tracer_plain(p["qx"], CornerPatch(p["qp"]), *c[:4],
                                            grid.area, c[4], c[5], 8)
            s = plain_exchange({"u": fx, "v": fy}, slabs.sync_plan("cgrid"))
            q = (q * dp1[:, None] + (x_iface_diff(s["u"]) + y_iface_diff(s["v"]))
                 * bcast_k(grid.rarea, q)) / dp2[:, None]
            dp1 = dp2
        return q, dp1

    qk, dk = demo.step(case, case.q, case.delp)
    qp_, dp_ = plain_step(case, case.q, case.delp)
    torch.cuda.synchronize()
    i = (..., slice(h, -h), slice(h, -h))
    step_rel = max(float(((qk[i] - qp_[i]).abs() / qp_[i].abs()).max()),
                   float(((dk[i] - dp_[i]).abs() / dp_[i].abs()).max()))
    log(f"[check] one step C{n} f32, kernel path vs plain path on the card: "
        f"max rel diff of q and dp {step_rel:.3e}")
    if not step_rel <= 1e-5:
        raise AssertionError(f"kernel path departs from the plain path: {step_rel}")
    del qk, dk, qp_, dp_, case, q, delp, crx, cry, xfx, yfx, mfx, mfy, fl, dpx, dpp
    torch.cuda.empty_cache()

    # --- the C-grid slice's kernels, inputs from the baroclinic-wave case
    t0 = time.perf_counter()
    ccase = cdemo.build_case(n, npz, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"[case] C{n} npz={npz} baroclinic-wave state built in {time.perf_counter() - t0:.1f} s")
    cgrid, chalo, st = ccase.grid, ccase.halo, ccase.state
    cslabs = chalo.slabs
    dt2 = ccase.dt2
    f32 = torch.float32

    # the exchanges of the path, as c_grid_half and c_sw make them
    u_y, v_x = chalo.update_vector_fold_pair(st.u, st.v, kind="dgrid")
    (delp_x, _), (pt_x, _) = chalo.update_scalars_fold_patches([st.delp, st.pt])
    d_args = (u_y, v_x, cgrid)
    d_got = d2k.d2a2c_cuda(*d_args)
    d_ref = d2a2c_ops.d2a2c_plain(*d_args)
    torch.cuda.synchronize()
    d_err = 0.0
    # ua, va agree on the whole plane, uc, vc on all but the outer two rings
    # (c_sw reads ring 2), ut, vt on all but the outer three
    for nm, a, b, r in zip(("ua", "va", "uc", "vc", "ut", "vt"), d_got, d_ref,
                           (0, 0, 2, 2, 3, 3)):
        a, b = ring(a, r), ring(b, r)
        d_err = max(d_err, check_close(f"d2a2c {nm} (outer {r} rings off)", a, b,
                                       4 * ulp * float(b.abs().max())))
    ms = time_ms(lambda: d2k.d2a2c_cuda(*d_args), 20)
    plain_ms = time_ms(lambda: d2a2c_ops.d2a2c_plain(*d_args), 3)
    d_consts = [getattr(cgrid, f) for f in d2a2c_ops.GRID_FIELDS]
    b_ms, b_by = bound(nbytes(u_y, v_x, *d_consts, *d_got),
                       D2A2C_OPS_PER_POINT * d_got[0].numel(), f32)
    results["d2a2c"] = dict(max_abs_err=d_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
    log(f"[time] d2a2c {tuple(u_y.shape)} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")

    ua, va, uc, vc, _ut, _vt = d_got
    del d_ref, _ut, _vt
    uc, vc = chalo.sync_vector_interfaces(uc, vc, kind="cgrid")
    uc_x, vc_x = chalo.update_vector(uc, vc, kind="cgrid", fold="x")
    uc_y, vc_y = chalo.update_vector(uc, vc, kind="cgrid", fold="y")
    ua_y, va_x = chalo.update_vector_fold_pair(ua, va, kind="agrid")
    t_args = (u_y, v_x, delp_x, pt_x, uc, vc, uc_x, vc_x, uc_y, vc_y, ua, va, va_x, ua_y,
              cgrid, dt2)
    t_got = ck.c_sw_tail_cuda(*t_args)
    t_ref = c_sw_ops.c_sw_tail_plain(*t_args)
    torch.cuda.synchronize()
    t_err = {}
    for nm, a, b in zip(("delpc", "ptc", "uc_new", "vc_new", "ut", "vt", "xfx", "yfx",
                         "divg_d"), t_got, t_ref):
        t_err[nm] = check_close(f"c_sw tail {nm} (whole plane)", a, b,
                                4 * ulp * float(b.abs().max()))
    ms = time_ms(lambda: ck.c_sw_tail_cuda(*t_args), 20)
    plain_ms = time_ms(lambda: c_sw_ops.c_sw_tail_plain(*t_args), 3)
    t_consts = [getattr(cgrid, c) for c in ck.CONSTS[:19]]
    t_consts += list(c_sw_ops.divergence_edge_weights(cgrid))
    b_ms, b_by = bound(nbytes(*t_args[:14], *t_consts, *t_got),
                       C_SW_TAIL_OPS_PER_POINT * t_got[0].numel(), f32)
    # max_abs_err of the line: the momentum update's (the outputs differ in
    # unit and magnitude; every one was held to 4 ulp of its maximum above)
    results["c_sw_tail"] = dict(max_abs_err=max(t_err["uc_new"], t_err["vc_new"]), ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
    log(f"[time] c_sw tail {tuple(delp_x.shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # the new exchange plans, on the path's own fields
    divg = t_got[8]
    new_plans = [
        ("dgrid fold pair", cslabs.vector_pair_plan("dgrid", "y", "x"), {"u": st.u, "v": st.v}),
        ("cgrid x-fold", cslabs.vector_plan("cgrid", "x"), {"u": uc, "v": vc}),
        ("cgrid y-fold", cslabs.vector_plan("cgrid", "y"), {"u": uc, "v": vc}),
        ("agrid fold pair", cslabs.vector_pair_plan("agrid", "y", "x"), {"u": ua, "v": va}),
        ("corner scalar x-fold", cslabs.scalar_plan("corner", "x"), {"q": divg}),
        ("scalar both folds", cslabs.scalar_folds_plan("center"), {"q": st.phis}),
    ]
    for label, plan, inputs in new_plans:
        lifted = {k: hk._lift(v) for k, v in inputs.items()}
        got = hk.halo_cuda(lifted, plan)
        ref = hk.halo_plain(lifted, plan)
        torch.cuda.synchronize()
        for name in ref:
            if not torch.equal(got[name], ref[name]):
                err = float((got[name] - ref[name]).abs().max())
                raise AssertionError(f"halo {label} output {name}: max abs err {err}")
        shapes = " ".join(str(tuple(v.shape)) for v in inputs.values())
        log(f"[check] halo {label} {shapes}: exact")
    del got, ref, lifted, new_plans, t_ref, uc_x, vc_x, uc_y, vc_y, ua_y, va_x, ua, va, uc, vc
    del t_args, d_args, d_got, u_y, v_x, delp_x, pt_x, divg

    # hydrostatic chain on the provisional C-grid state
    delpc, ptc = t_got[0], t_got[1]
    del t_got
    K = delpc.shape[1]
    h_all = ("pe", "peln", "pk", "pkz", "gz")
    h_ref = pgrad_ops.hydrostatic_interfaces(delpc, ptc, st.phis, cgrid.ptop)
    h_f64 = pgrad_ops.hydrostatic_interfaces(delpc.double(), ptc.double(), st.phis.double(),
                                             cgrid.ptop)
    h_got = hyk.hydrostatic_interfaces_cuda(delpc, ptc, st.phis, cgrid.ptop, need=h_all)
    torch.cuda.synchronize()
    pk64, peln64 = h_f64[2], h_f64[1]
    amp = float(torch.maximum(pk64[:, 1:] / (pk64[:, 1:] - pk64[:, :-1]).abs(),
                              1.0 / (peln64[:, 1:] - peln64[:, :-1]).abs()).max())
    log(f"[check] hydro: K={K}, cancellation factor max(pk/dpk, 1/dpeln) = {amp:.1f}")
    h_err = {nm: check_against_f64(f"hydro {nm}", a, b, c, ulp)
             for nm, a, b, c in zip(h_all, h_got, h_ref, h_f64)}
    del h_f64, pk64, peln64
    for need in (("pk", "pkz", "gz"), ("pkz",)):
        pruned = hyk.hydrostatic_interfaces_cuda(delpc, ptc, st.phis, cgrid.ptop, need=need)
        torch.cuda.synchronize()
        for nm, a, b in zip(h_all, pruned, h_got):
            if (a is None) != (nm not in need) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"hydro need={need}: output {nm} wrong or not pruned")
        ms = time_ms(lambda: hyk.hydrostatic_interfaces_cuda(
            delpc, ptc, st.phis, cgrid.ptop, need=need), 20)
        reads = (delpc, ptc, st.phis) if "gz" in need else (delpc,)
        b_ms, b_by = bound(nbytes(*reads, *pruned), HYDRO_OPS_PER_POINT * delpc.numel(), f32)
        log(f"[time] hydro need={need} {tuple(delpc.shape)} f32: kernel {ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if "gz" in need:  # the main path's call
            plain_ms = time_ms(lambda: pgrad_ops.hydrostatic_interfaces(
                delpc, ptc, st.phis, cgrid.ptop), 3)
            # max_abs_err of the line: pk's (dimensionless, the PGF's operand)
            results["hydro"] = dict(max_abs_err=h_err["pk"], ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"[time] hydro plain version (all five outputs): {plain_ms:.4f} ms")
    del h_ref, h_got, pruned, delpc, ptc, ccase, st, cgrid, chalo, cslabs
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # 3. small-input reference: C24 f64, card kernels vs CPU plain path
    # ------------------------------------------------------------------
    small = dict(n=24, npz=4, nq=3, dt=DT, steps=3, dtype=torch.float64)
    a = demo.run(device=dev, **small)
    b = demo.run(device="cpu", **small)
    rel = max(float(((a["q"][i].cpu() - b["q"][i]).abs() / b["q"][i].abs()).max()),
              float(((a["delp"][i].cpu() - b["delp"][i]).abs() / b["delp"][i].abs()).max()))
    log(f"[check] C24 f64 3 steps, card kernels vs CPU plain path: max rel diff {rel:.3e}")
    if not rel <= 1e-12:
        raise AssertionError(f"C24 f64 card run departs from the CPU reference: {rel}")

    def half_outputs(half):
        cg = half.cg
        return dict(
            uc_x=half.uc_x, vc_x=half.vc_x, uc_y=half.uc_y, vc_y=half.vc_y, u_y=half.u_y,
            v_x=half.v_x, delp_x=half.delp_x, pt_x=half.pt_x, pkz_c=half.pkz_c,
            delpc=cg.delpc, ptc=cg.ptc, cg_uc=cg.uc, cg_vc=cg.vc, ut=cg.ut, vt=cg.vt,
            ua=cg.ua, va=cg.va, divg_d=cg.divg_d, xfx=cg.xfx, yfx=cg.yfx,
        )

    a = half_outputs(cdemo.step(cdemo.build_case(24, 8, device=dev, dtype=torch.float64)))
    b = half_outputs(cdemo.step(cdemo.build_case(24, 8, device="cpu", dtype=torch.float64)))
    rel, worst = 0.0, ""
    for nm in a:
        x, y = a[nm][i].cpu(), b[nm][i]
        r = float((x - y).abs().max() / y.abs().max())
        if r > rel:
            rel, worst = r, nm
    log(f"[check] C24 npz=8 f64 C-grid half step, card kernels vs CPU plain path: max diff "
        f"{rel:.3e} of each output's maximum (largest on {worst or 'none'})")
    if not rel <= 1e-12:
        raise AssertionError(f"C24 f64 C-grid half step departs from the CPU reference: "
                             f"{rel} on {worst}")
    del a, b

    # ------------------------------------------------------------------
    # 4. the slice through its entry point, launch counts around it
    # ------------------------------------------------------------------
    counters = {"halo": hk.LAUNCHES, "fvtp2d": fk.LAUNCHES, "fvtp2d_tracer": fk.LAUNCHES,
                "d2a2c": d2k.LAUNCHES, "c_sw_tail": ck.LAUNCHES, "hydro": hyk.LAUNCHES}

    def zero_counters():
        for c in counters.values():
            for k in c:
                c[k] = 0

    zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    out = demo.run(n=n, npz=npz, nq=nq, dt=DT, steps=steps, device=dev, dtype=torch.float32)
    launches = {k: c[k] for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[slice] C{n} npz={npz} nq={nq} f32 dt={DT:.0f} s, {steps} steps: "
        f"{out['n_subcycles']} sub-cycles/step, {out['ms_per_step']:.3f} ms/step after the "
        f"first (step ms: {', '.join(f'{t:.3f}' for t in out['step_ms'])}), "
        f"peak memory {peak_gb:.2f} GB")
    log(f"[slice] tracer mass drift {out['mass_drift']:.3e}, dp drift {out['dp_drift']:.3e}, "
        f"q min {out['q_min']:.6f} (floor {out['q_floor']:.6f}), q max {out['q_max']:.3f}, "
        f"finite {out['finite']}")
    log(f"[slice] launches: {launches}")
    failures = []
    if out["n_subcycles"] < 1:
        failures.append("no sub-cycle")
    if not out["finite"]:
        failures.append("non-finite fields")
    if not out["mass_drift"] <= 1e-5:
        failures.append(f"tracer mass drift {out['mass_drift']}")
    if not out["q_min"] >= out["q_floor"]:
        failures.append(f"q min {out['q_min']} below {out['q_floor']}")
    for k in ("halo", "fvtp2d", "fvtp2d_tracer"):
        if launches[k] <= 0:
            failures.append(f"kernel {k} not launched on the transport path")
    if failures:
        raise AssertionError("slice checks failed: " + "; ".join(failures))

    # --- the C-grid half step through its entry point
    c_repeats = 4
    zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    cout = cdemo.run(n=n, npz=npz, repeats=c_repeats, device=dev, dtype=torch.float32)
    c_launches = {k: c[k] for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[cgrid] C{n} npz={npz} f32 dt2={cdemo.DT2:.4f} s, {c_repeats} half steps: "
        f"{cout['ms_per_half_step']:.3f} ms/half step after the first (ms: "
        f"{', '.join(f'{t:.3f}' for t in cout['step_ms'])}), peak memory {peak_gb:.2f} GB")
    log(f"[cgrid] finite {cout['finite']}, delpc min {cout['delpc_min']:.4f}, mass drift "
        f"{cout['mass_drift']:.3e}, ptc in [{cout['ptc_min']:.4f}, {cout['ptc_max']:.4f}] "
        f"(allowed [{cout['pt_floor']:.4f}, {cout['pt_ceil']:.4f}]), pkz in "
        f"[{cout['pkz_min']:.6f}, {cout['pkz_max']:.6f}], max|uc| {cout['uc_max']:.3f}")
    log(f"[cgrid] launches: {c_launches}")
    failures = []
    if not cout["finite"]:
        failures.append("non-finite fields")
    if not cout["delpc_min"] > 0:
        failures.append(f"delpc min {cout['delpc_min']}")
    if not cout["mass_drift"] <= 1e-6:
        failures.append(f"delpc mass drift {cout['mass_drift']}")
    if not (cout["pt_floor"] <= cout["ptc_min"] and cout["ptc_max"] <= cout["pt_ceil"]):
        failures.append(f"ptc range [{cout['ptc_min']}, {cout['ptc_max']}]")
    if not (0 < cout["pkz_min"] and cout["pkz_max"] < 1.2):
        failures.append(f"pkz range [{cout['pkz_min']}, {cout['pkz_max']}]")
    for k in ("halo", "d2a2c", "c_sw_tail", "hydro"):
        if c_launches[k] <= 0:
            failures.append(f"kernel {k} not launched on the C-grid path")
    # balance of the unperturbed (steady) state, after the counts were read
    bal = cdemo.steady_state_residual(n, npz, device=dev, dtype=torch.float32)
    log(f"[cgrid] unperturbed state: rms wind tendency {bal['tendency_rms']:.4e} m/s^2, rms "
        f"pressure-gradient term {bal['pgf_rms']:.4e} m/s^2, ratio {bal['ratio']:.4f} "
        f"(allowed {BALANCE_RATIO_MAX})")
    if not 0 < bal["ratio"] <= BALANCE_RATIO_MAX:
        failures.append(f"balance ratio {bal['ratio']}")
    if failures:
        raise AssertionError("C-grid slice checks failed: " + "; ".join(failures))

    # ------------------------------------------------------------------
    # 5. where the time goes: two more steps under the profiler (after the
    #    launch counts were read), device time by kernel
    # ------------------------------------------------------------------
    state = {"q": out["q"], "dp": out["delp"]}

    def transport_step():
        state["q"], state["dp"] = demo.step(out["case"], state["q"], state["dp"])

    profile_steps("tracer advection", transport_step, out["ms_per_step"])
    profile_steps("C-grid half step", lambda: cdemo.step(cout["case"]),
                  cout["ms_per_half_step"])

    meta = {
        "halo": ("pace_tpu_torch/csrc/halo.cu", "pace_tpu/parallel/halo_pallas.py:71"),
        "fvtp2d": ("pace_tpu_torch/csrc/fvtp2d.cu", "pace_tpu/ops/fvtp2d_pallas.py:135"),
        "fvtp2d_tracer": ("pace_tpu_torch/csrc/fvtp2d.cu", "pace_tpu/ops/fvtp2d_pallas.py:419"),
        "d2a2c": ("pace_tpu_torch/csrc/d2a2c.cu", "pace_tpu/ops/d2a2c_pallas.py:33"),
        "c_sw_tail": ("pace_tpu_torch/csrc/c_sw_tail.cu", "pace_tpu/ops/c_sw_tail_pallas.py:197"),
        "hydro": ("pace_tpu_torch/csrc/hydro.cu", "pace_tpu/ops/hydro_pallas.py:37"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        by_path = {"tracer_advection": launches[name], "cgrid_half_step": c_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
