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
   measured against its float64 evaluation (see ``check_against_f64``).
   Nonhydrostatic vertical, on the fields of one nonhydrostatic half step:
   the interface heights by the same float64 yardstick, ``updatedz_c``
   within 4 ulp of each output's maximum, and the vertical solve (sim1) on
   the columns a consumer reads, within 4 ulp of each output's maximum on
   the compute domain in float32 and within ``SIM1_F64_REL_TOL`` of it in
   float64 (see ``check_sim1``);
3. small-input references in float64, kernel path on the card against the
   plain path on the CPU: the tracer-advection demo at C24 and the C-grid
   half step at C24 in both configurations, within 1e-12, and the three
   outputs of the vertical solve on that half step's fields;
4. the slices through their user entry points, each with every launch
   counter set to 0 just before and read just after: the tracer-advection
   demo at C192, npz=79, nq=9, f32, dt=1800 s, 6 steps (conservation,
   monotonicity, finiteness); the C-grid half of an acoustic substep from
   the baroclinic-wave state at C192, npz=79, f32, 8 repeats, hydrostatic
   (finiteness, positivity and conservation of delpc, range of ptc and pkz,
   and the balance of the unperturbed state); and the same half step in the
   nonhydrostatic configuration of the dycore benchmark (those gates, the
   exact launch counts per half step, negative thicknesses, heights
   decreasing downward with the bottom interface on the surface, and bounds
   on the perturbation pressure and the surface velocity); and one acoustic
   substep as far as it is ported (the C-grid half, then ``d_sw``, the
   dissipation heating, ``updatedz_d`` and ``riem_solver3``) in that
   configuration, 8 timed repeats after the warm ones (the exact launch
   counts per substep, conservation of mass, heat and w across ``d_sw``, the
   heating cap, negative thicknesses, the bottom interface on the surface,
   bounds on the perturbation pressure and the surface velocity, and the
   size of the D-grid wind tendency of the unperturbed state);
5. where the time goes: two more steps of each demo under
   ``torch.profiler``, device time by kernel.

The last lines are the card's name and power limit (``nvidia-smi``), the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
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

# Operations per output point of the nonhydrostatic vertical's kernels:
#   heights: the running sum and its subtraction from the surface height = 2;
#   updatedz_c, per interface and cell: four interface averages 8, upwind
#          compares 4, flux products 4, both flux differences and their sums
#          4, zh*area 1, the denominator 4, the division 1 = 26;
#   sim1, per layer and column, each term once (the kernel forms some twice):
#          dm, t_v, p_full 6, the pressure sum, floor, log and log-mean
#          pressure 6, pprime and B 5, interface mass and velocity 7, the row
#          (r, a, b, c, rhs) 11, elimination 6, substitution and divergence 3,
#          delz with the floor 6, pprime_new 2, pp at the interface 5, w 4 = 61.
HEIGHTS_OPS_PER_POINT = 2
UPDATEDZ_C_OPS_PER_POINT = 26
SIM1_OPS_PER_POINT = 61

# Operations per output point of the D-grid half's kernels:
#   fvtp2d multi: per field the scheme's count at its hord
#          (FVTP2D_OPS_PER_POINT), the two updated areas 4 once;
#   d_sw tail at nord 3 with every switch on, each term once (the kernel
#          forms each corner gradient twice): kinetic energy 10, the
#          Smagorinsky coefficient 16, chi 2, three Laplacians 9 each, the
#          high-order term and the band blend 7, dtke 2, u_new and v_new 6
#          each, the four edge increments and energies 14, heat 6 = 96;
#   flux_height_update: two flux differences and two area-flux differences 4,
#          their sums 4, zh*area 1, the division 1 = 10.
D_SW_TAIL_OPS_PER_POINT = 96
FLUX_HEIGHT_OPS_PER_POINT = 10

#: acceptance threshold of the balance check: rms C-grid wind tendency of the
#: unperturbed baroclinic state over rms pressure-gradient term. The demo on
#: the CPU in float64, where it equals pace_tpu to 1e-12, gives 0.0517 at C24
#: and 0.0563 at C48 (``cgrid_half_step --npz 79 --device cpu --f64``); the
#: ratio grows slowly with resolution, and a missing or wrong term gives O(1)
BALANCE_RATIO_MAX = 0.15

#: gates of the nonhydrostatic half step from the balanced baroclinic-wave
#: state (w = 0, delz hydrostatic). The demo on the CPU in float64, where it
#: equals pace_tpu to 1e-12, gives at npz=79 (``cgrid_half_step --npz 79
#: --device cpu --f64 --nonhydrostatic``) max|pp|/pe 1.455e-05 at C24 and
#: 3.596e-05 at C48, and max|ws_c| 2.101e-04 and 2.522e-04 m/s. Both grow with
#: resolution (2.5x and 1.2x per doubling, so about 2.2e-04 and 3.6e-04 m/s
#: at C192), and in float32 pp also carries the rounding of two pressures
#: near 1e5 Pa, amplified where a thin layer's log-pressure difference
#: cancels (1.8e-04 at C24 on the CPU). The limits leave a factor of five
#: or more; a solve on inconsistent heights gives pp of the order of pe.
PP_REL_MAX = 2e-3
WS_MAX = 2e-3
#: kernel launches of one nonhydrostatic half step
NH_LAUNCHES_PER_HALF_STEP = {"heights": 3, "updatedz_c": 1, "sim1": 1, "hydro": 1,
                             "d2a2c": 1, "c_sw_tail": 1}


#: gates of the substep up to the vertical solve (``[substep]``), from the
#: demo on the CPU in float64 at npz=79 (``acoustic_substep --npz 79 --device
#: cpu --f64``; it equals pace_tpu to 1e-12 there). max|pp|/pe after
#: riem_solver3 is 2.603e-05 at C24 and 6.309e-05 at C48, max|ws| 7.937e-05 and
#: 1.089e-04 m/s: 2.4x and 1.4x per doubling, so about 3.6e-04 and 2.1e-04 m/s
#: at C192, and PP_REL_MAX and WS_MAX above leave a factor of five or more.
#: sum(delp area), sum(pt delp area) and sum(w delp area) change across d_sw
#: by 1.6e-16 and 1.2e-16 in float64 (w stays 0); in float32 at C24 by
#: 1.951e-12 and 1.404e-10, the rounding of each cell's update; DRIFT_MAX
#: leaves a factor of 70, and a flux that is not synced across a tile edge
#: shows at 1e-6. The heating increment reaches 4.492e-03 K at C24 and
#: 1.217e-03 K at C48 under a cap of 7.143e-03 K; in float32 it is read back as
#: a difference of two pt near 1e3 K, so two ulp of max pt are allowed on top.
#: The unperturbed state is steady, so the D-grid pressure gradient (not
#: ported yet) must cancel the wind change of d_sw: the ratio of that
#: change's rms tendency to the rms C-grid pressure-gradient term, whose
#: balance is gated above, is 1.006 at C24 and 0.981 at C48 (1.088 and 0.968
#: at npz=8); a missing momentum term or a wrong vorticity flux moves it by
#: tens of percent (3.27 at C12, where truncation error dominates).
DRIFT_MAX = 1e-8
D_SW_BALANCE_RANGE = (0.8, 1.25)
#: kernel launches of one nonhydrostatic substep up to the vertical solve
LAUNCHES_PER_SUBSTEP = {"d2a2c": 1, "c_sw_tail": 1, "updatedz_c": 1, "heights": 4, "sim1": 2,
                        "hydro": 2, "fvtp2d": 2, "fvtp2d_multi": 1, "d_sw_tail": 1,
                        "flux_height_update": 1, "halo": 44}
#: launches the demo makes once, when it builds its case: phis in both folds
SUBSTEP_SETUP_LAUNCHES = {"halo": 2}


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


def log_identical(label, got, ref):
    """Log how many points of ``got`` differ from the plain version at all."""
    n_diff = int((got != ref).sum())
    log(f"[check] {label}: {n_diff} of {got.numel()} points differ from the plain version"
        + (" (bit-identical)" if n_diff == 0 else ""))


#: float64 tolerances of the vertical solve, as shares of each output's
#: maximum on the compute domain. ``w`` and ``pp`` come from the difference of
#: two pressures near 1e5 Pa (amplified up to a few thousand times where a
#: thin layer's log-pressure difference cancels), so one ulp of a ``log``
#: shows as about 1e-10 of ``pp`` and, divided by the small mass of the thin
#: top layers, 1e-8 of ``w``; the thicknesses carry no such difference.
SIM1_F64_REL_TOL = {"w": 1e-6, "delz": 1e-12, "pp": 1e-7}


def check_sim1(label, got, ref, rel_tol):
    """Hold the vertical solve's ``(w, delz, pp)`` against the plain version
    on the columns a consumer reads (the compute domain and one cell around
    it, which ``p_grad_c`` reads), each within ``rel_tol[name]`` of the plain
    output's maximum on the compute domain alone: the ghost columns, solved
    from area fluxes that are not valid there, must not widen the tolerance.
    Returns the max abs errors by name."""
    errs = {}
    for nm, a, b in zip(("w", "delz", "pp"), got, ref):
        scale = float(ring(b, 3).abs().max())
        errs[nm] = check_close(f"{label} {nm} (compute domain and one cell)",
                               ring(a, 2), ring(b, 2), rel_tol[nm] * scale)
        log_identical(f"{label} {nm}", ring(a, 2), ring(b, 2))
    return errs


def profile_steps(label, step_fn, wall_ms, top=10):
    """Two calls of ``step_fn`` under torch.profiler: device time by kernel,
    the ``top`` largest."""
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
        for name, t, n_calls in rows[:top]:
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
    from pace_tpu_torch import _build, constants
    from pace_tpu_torch.demos import acoustic_substep as sdemo
    from pace_tpu_torch.demos import cgrid_half_step as cdemo
    from pace_tpu_torch.demos import tracer_advection as demo
    from pace_tpu_torch.ops import c_sw as c_sw_ops
    from pace_tpu_torch.ops import c_sw_tail_kernel as ck
    from pace_tpu_torch.ops import d2a2c as d2a2c_ops
    from pace_tpu_torch.ops import d2a2c_kernel as d2k
    from pace_tpu_torch.ops import d_sw as d_sw_ops
    from pace_tpu_torch.ops import d_sw_tail_kernel as dtk
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops import hydro_kernel as hyk
    from pace_tpu_torch.ops import nonhydro as nh_ops
    from pace_tpu_torch.ops import pgrad as pgrad_ops
    from pace_tpu_torch.ops import sim1_kernel as s1k
    from pace_tpu_torch.ops import updatedz_kernel as uzk
    from pace_tpu_torch.ops.delnflux import delnflux, lap_corner_weights
    from pace_tpu_torch.ops.folds import CornerPatch
    from pace_tpu_torch.ops.fvtp2d import fvtp2d_best
    from pace_tpu_torch.ops.fxadv import flux_prep_x, flux_prep_y
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
    del h_ref, h_got, pruned, delpc, ptc
    torch.cuda.empty_cache()

    # --- the nonhydrostatic vertical's kernels, on the fields of one
    #     nonhydrostatic half step from the same state
    ncase = dataclasses.replace(ccase, config=cdemo.AcousticConfig(hydrostatic=False),
                                phis_folds=chalo.update_scalar_folds(st.phis))
    nhalf = cdemo.step(ncase)
    torch.cuda.synchronize()
    area = cgrid.area

    def dbl(*ts):
        return [t.double() for t in ts]

    # interface heights of the exchanged delz (x fold)
    z_args = (nhalf.delz_x, nhalf.phis_folds[0])
    z_got = uzk.heights_from_delz_cuda(*z_args)
    z_ref = nh_ops.heights_from_delz_plain(*z_args)
    z_f64 = nh_ops.heights_from_delz_plain(*dbl(*z_args))
    torch.cuda.synchronize()
    z_err = check_against_f64("heights zh", z_got, z_ref, z_f64, ulp)
    log_identical("heights zh", z_got, z_ref)
    ms = time_ms(lambda: uzk.heights_from_delz_cuda(*z_args), 20)
    plain_ms = time_ms(lambda: nh_ops.heights_from_delz_plain(*z_args), 5)
    # one-call yardstick: the running sum alone, on a field flipped beforehand
    # (the function also flips twice and subtracts the sum from the surface)
    flipped = torch.flip(z_args[0], dims=(1,)).contiguous()
    z_lib = z_ref[:, -1:] - torch.flip(torch.cumsum(flipped, dim=1), dims=(1,))
    log(f"[check] heights: surface height less torch.cumsum of the flipped field differs from "
        f"the plain version at {int((z_lib != z_ref[:, :-1]).sum())} points")
    del z_lib
    library_ms = time_ms(lambda: torch.cumsum(flipped, dim=1), 20)
    b_ms, b_by = bound(nbytes(*z_args, z_got), HEIGHTS_OPS_PER_POINT * z_args[0].numel(), f32)
    results["heights"] = dict(max_abs_err=z_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=library_ms)
    log(f"[time] heights {tuple(z_args[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.cumsum {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del z_got, z_ref, z_f64, flipped

    # updatedz_c on the heights of both folds and c_sw's area fluxes; the
    # outermost ring is unspecified
    u_args = (nhalf.zh_x, nhalf.zh_y, nhalf.cg.xfx, nhalf.cg.yfx, area, dt2)
    u_got = uzk.updatedz_c_cuda(*u_args)
    u_ref = nh_ops.updatedz_c_plain(*u_args)
    torch.cuda.synchronize()
    u_err = {}
    for nm, a, b in zip(("zh", "ws"), u_got, u_ref):
        a, b = ring(a, 1), ring(b, 1)
        u_err[nm] = check_close(f"updatedz_c {nm} (outer ring off)", a, b,
                                4 * ulp * float(b.abs().max()))
        log_identical(f"updatedz_c {nm}", a, b)
    ms = time_ms(lambda: uzk.updatedz_c_cuda(*u_args), 20)
    plain_ms = time_ms(lambda: nh_ops.updatedz_c_plain(*u_args), 3)
    b_ms, b_by = bound(nbytes(*u_args[:5], *u_got),
                       UPDATEDZ_C_OPS_PER_POINT * u_got[0].numel(), f32)
    results["updatedz_c"] = dict(max_abs_err=u_err["zh"], ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] updatedz_c {tuple(u_args[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # sim1 as riem_solver_c calls it; held on the columns a consumer reads
    # (p_grad_c reads one cell beyond the compute domain; further out the
    # area fluxes, hence ws_c and the solve, are not valid by design)
    zh_c = u_got[0]
    s_args = (nhalf.w_x, zh_c[:, 1:] - zh_c[:, :-1], nhalf.cg.ptc, nhalf.cg.delpc,
              nhalf.pkz_c, u_got[1])
    del u_got, u_ref, zh_c
    p_fac = ncase.config.p_fac

    def sim1_plain(args):
        w_n, dz_n, pp_n = nh_ops.sim1_solver(*args, dt2, cgrid.ptop)
        return w_n, nh_ops._p_fac_floor(dz_n, *args[2:5], cgrid.ptop, p_fac), pp_n

    # float32: the difference of two pressures near 1e5 Pa leaves the plain
    # version itself further from its float64 evaluation than w and pp are
    # large, so that error is no yardstick here. The kernel keeps the plain
    # version's operation order, and on this card torch.log rounds as logf
    # and torch.cumsum sums in sequence: held to 4 ulp of each output's
    # maximum on the compute domain, i.e. to the same roundings.
    s_got = s1k.sim1_solver_cuda(*s_args, dt2, cgrid.ptop, p_fac=p_fac)
    s_ref = sim1_plain(s_args)
    torch.cuda.synchronize()
    s_err = check_sim1("sim1 f32", s_got, s_ref, dict.fromkeys(("w", "delz", "pp"), 4 * ulp))
    # float64 at the same shapes, where the amplified rounding is far below
    # the values: the kernel's formulas, independent of how log rounds
    s_args64 = dbl(*s_args)
    s_got64 = s1k.sim1_solver_cuda(*s_args64, dt2, cgrid.ptop, p_fac=p_fac)
    s_f64 = sim1_plain(s_args64)
    torch.cuda.synchronize()
    check_sim1("sim1 f64", s_got64, s_f64, SIM1_F64_REL_TOL)
    for nm, a, b in zip(("w", "delz", "pp"), s_ref, s_f64):
        log(f"[check] sim1 {nm}: the plain float32 version is "
            f"{float((ring(a, 3).double() - ring(b, 3)).abs().max()):.3e} from its float64 "
            f"evaluation on the compute domain (max {float(ring(b, 3).abs().max()):.3e})")
    del s_f64, s_got64, s_args64
    ms = time_ms(lambda: s1k.sim1_solver_cuda(*s_args, dt2, cgrid.ptop, p_fac=p_fac), 20)
    plain_ms = time_ms(lambda: sim1_plain(s_args), 2)
    b_ms, b_by = bound(nbytes(*s_args, *s_got), SIM1_OPS_PER_POINT * s_args[0].numel(), f32)
    # max_abs_err of the line: pp's [Pa], the pressure gradient's operand
    results["sim1"] = dict(max_abs_err=s_err["pp"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
    log(f"[time] sim1 {tuple(s_args[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del s_got, s_ref, s_args, u_args, z_args, nhalf, ncase, area
    del ccase, st, cgrid, chalo, cslabs
    torch.cuda.empty_cache()

    # --- the D-grid half's kernels, on the fields of one substep in the
    #     dycore benchmark's configuration: d_sw's own sequence up to each
    #     kernel's operands (real ghost columns and cube corners, not noise)
    scase = sdemo.build_case(n, npz, device=dev, dtype=f32)
    sgrid, shalo, scfg = scase.grid, scase.halo, scase.config.d_sw
    dt = 2.0 * scase.dt2
    st = scase.state
    chalf, _dhalf = sdemo.step(scase)
    del _dhalf
    crx, xfx, ut = flux_prep_x(chalf.uc_x, chalf.vc_x, sgrid, dt)
    cry, yfx, vt = flux_prep_y(chalf.uc_y, chalf.vc_y, sgrid, dt)
    vort = d_sw_ops.absolute_vorticity_centers(chalf.u_y, chalf.v_x, sgrid)
    vort_x, vort_p = shalo.update_scalar_fold_patch(vort)
    fl = fvtp2d_best(chalf.delp_x, chalf.delp_y, crx, cry, xfx, yfx, sgrid.area, scfg.hord_dp)
    mfx, mfy = shalo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    del fl
    trio = [(chalf.pt_x, chalf.pt_y, scfg.hord_tm, True),
            (vort_x, CornerPatch(vort_p), scfg.hord_vt, False),
            (chalf.w_x, chalf.w_y, scfg.hord_vt, True)]
    m_args = (trio, crx, cry, xfx, yfx, sgrid.area)
    m_got = fk.fvtp2d_multi_cuda(*m_args, mfx=mfx, mfy=mfy)
    m_ref = fk.fvtp2d_multi_plain(*m_args, mfx=mfx, mfy=mfy)
    torch.cuda.synchronize()
    m_err = 0.0
    for fname, got, ref, (qx, qy, hord, use_mf) in zip(("pt", "vort", "w"), m_got, m_ref, trio):
        kw = dict(mfx=mfx, mfy=mfy) if use_mf else {}
        single = fk.fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, sgrid.area, hord, **kw)
        torch.cuda.synchronize()
        for nm, a, b, c in zip(("fx", "fy"), got, ref, single):
            if not torch.equal(a, c):
                raise AssertionError(f"fvtp2d multi {fname} {nm} differs from the single-field "
                                     f"launch at {int((a != c).sum())} points")
            a, b = consumed(a), consumed(b)
            scale = float(b.abs().max())
            # w = 0 in the analytic state: its fluxes are exactly zero on both sides
            e = check_close(f"fvtp2d multi {fname} {nm} (consumed region; equal to the "
                            f"single-field launch everywhere)", a, b, 4 * ulp * scale)
            log_identical(f"fvtp2d multi {fname} {nm}", a, b)
            if fname == "pt":
                m_err = max(m_err, e)
        del single
    # the instantiations and the y-fold form the main path does not reach
    # (hord 8 and 7, a full-array y fold, four fields), against single launches
    extra = [(chalf.pt_x, chalf.pt_x, 8, False), (vort_x, CornerPatch(vort_p), 7, True),
             (chalf.delp_x, chalf.delp_y, 1, False), (chalf.pt_x, chalf.pt_y, 5, True)]
    e_got = fk.fvtp2d_multi_cuda(extra, *m_args[1:], mfx=mfx, mfy=mfy)
    for (qx, qy, hord, use_mf), pair in zip(extra, e_got):
        kw = dict(mfx=mfx, mfy=mfy) if use_mf else {}
        single = fk.fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, sgrid.area, hord, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(pair[0], single[0]) and torch.equal(pair[1], single[1])):
            raise AssertionError(f"fvtp2d multi hord {hord} differs from the single-field launch")
    log("[check] fvtp2d multi, four fields with hord 8, 7, 1, 5 (one y fold a full array): "
        "equal to the single-field launches")
    del extra, e_got, single, pair
    ms = time_ms(lambda: fk.fvtp2d_multi_cuda(*m_args, mfx=mfx, mfy=mfy), 20)
    plain_ms = time_ms(lambda: fk.fvtp2d_multi_plain(*m_args, mfx=mfx, mfy=mfy), 2)
    single_ms = time_ms(lambda: [
        fk.fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, sgrid.area, hord,
                       **(dict(mfx=mfx, mfy=mfy) if use_mf else {}))
        for qx, qy, hord, use_mf in trio], 20)
    m_in = [t for qx, qy, _h, _m in trio for t in (qx, qy.data)]
    m_out = [t for pair in m_got for t in pair]
    m_ops = (sum(FVTP2D_OPS_PER_POINT[6 if h_ == 5 else h_] for _x, _y, h_, _m in trio) + 4)
    b_ms, b_by = bound(nbytes(*m_in, crx, cry, xfx, yfx, sgrid.area, mfx, mfy, *m_out),
                       m_ops * vort.numel(), f32)
    # max_abs_err of the line: the pt fluxes' (the three fields differ in unit)
    results["fvtp2d_multi"] = dict(max_abs_err=m_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)
    log(f"[time] fvtp2d multi 3 x {tuple(vort.shape)} f32 hord {[t[2] for t in trio]}: kernel "
        f"{ms:.4f} ms, three single-field launches {single_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del m_ref, m_in, m_out

    # the tail's operands: synced vorticity fluxes and vorticity damping fluxes
    vfx, vfy = shalo.sync_vector_interfaces(*m_got[1], kind="cgrid")
    del m_got, trio, m_args
    dvfx, dvfy = delnflux(vort_x, sgrid, min(2, scfg.nord), scfg.vtdm4, sgrid.da_min)
    dvfx, dvfy = shalo.sync_vector_interfaces(dvfx, dvfy, kind="cgrid")
    divg = chalf.cg.divg_d
    tail_cases = [
        ("bench", scfg, (dvfx, dvfy)),
        ("nord 1, no band, heat or vorticity damping",
         d_sw_ops.DSWConfig(nord=1, d4_bg=0.16, dddmp=0.0, d_con=0.0, vtdm4=0.0,
                            edge_damp_band=False), (None, None)),
    ]
    for label, tcfg, (dx_, dy_) in tail_cases:
        t_args = (chalf.u_y, chalf.v_x, ut, vt, divg, vort, vfx, vfy, dx_, dy_, sgrid, dt, tcfg)
        t_got = dtk.d_sw_tail_cuda(*t_args)
        t_ref = d_sw_ops.d_sw_tail_plain(*t_args)
        torch.cuda.synchronize()
        t_err = {}
        for nm, a, b in zip(("u_new", "v_new", "heat"), t_got, t_ref):
            if b is None:
                if a is not None:
                    raise AssertionError(f"d_sw tail ({label}): {nm} returned, none expected")
                continue
            t_err[nm] = check_close(f"d_sw tail ({label}) {nm} (compute domain)", ring(a, 3),
                                    ring(b, 3), 4 * ulp * float(ring(b, 3).abs().max()))
            log_identical(f"d_sw tail ({label}) {nm}, whole plane", a, b)
        if tcfg is scfg:  # the main path's call
            ms = time_ms(lambda: dtk.d_sw_tail_cuda(*t_args), 20)
            plain_ms = time_ms(lambda: d_sw_ops.d_sw_tail_plain(*t_args), 3)
            t_consts = [getattr(sgrid, c) for c in dtk.CONSTS if not c.startswith("wg")]
            t_consts += list(lap_corner_weights(sgrid)) + [getattr(sgrid, c) for c in dtk.EDGES]
            b_ms, b_by = bound(nbytes(*t_args[:10], *t_consts, *t_got),
                               D_SW_TAIL_OPS_PER_POINT * vort.numel(), f32)
            # max_abs_err of the line: the momentum update's
            results["d_sw_tail"] = dict(max_abs_err=max(t_err["u_new"], t_err["v_new"]), ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=None)
            log(f"[time] d_sw tail {tuple(vort.shape)} f32 nord {tcfg.nord}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del t_got, t_ref, t_args
    del vfx, vfy, dvfx, dvfy, vort, vort_x, vort_p, ut, vt, divg, tail_cases

    # the flux-form height update, as updatedz_d calls it: interface-averaged
    # fluxes and the hord-5 fluxes of the heights over K+1 interfaces
    crx_i, cry_i, xfx_i, yfx_i = (nh_ops._to_iface(f) for f in (crx, cry, xfx, yfx))
    del crx, cry, xfx, yfx, mfx, mfy
    fl = fvtp2d_best(chalf.zh_x, chalf.zh_y, crx_i, cry_i, xfx_i, yfx_i, sgrid.area, 5)
    f_args = (chalf.zh_x, fl.fx, fl.fy, xfx_i, yfx_i, sgrid.area)
    f_got = uzk.flux_height_update_cuda(*f_args)
    f_ref = nh_ops.flux_height_update_plain(*f_args)
    torch.cuda.synchronize()
    f_err = check_close("flux_height_update zh (compute domain)", ring(f_got, 3), ring(f_ref, 3),
                        4 * ulp * float(ring(f_ref, 3).abs().max()))
    log_identical("flux_height_update zh, whole plane", f_got, f_ref)
    ms = time_ms(lambda: uzk.flux_height_update_cuda(*f_args), 20)
    plain_ms = time_ms(lambda: nh_ops.flux_height_update_plain(*f_args), 3)
    b_ms, b_by = bound(nbytes(*f_args, f_got), FLUX_HEIGHT_OPS_PER_POINT * f_got.numel(), f32)
    results["flux_height_update"] = dict(max_abs_err=f_err, ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] flux_height_update {tuple(f_got.shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del f_got, f_ref, f_args, fl, crx_i, cry_i, xfx_i, yfx_i, chalf, scase, sgrid, shalo, st
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
        outs = dict(
            uc_x=half.uc_x, vc_x=half.vc_x, uc_y=half.uc_y, vc_y=half.vc_y, u_y=half.u_y,
            v_x=half.v_x, delp_x=half.delp_x, pt_x=half.pt_x, pkz_c=half.pkz_c,
            delpc=cg.delpc, ptc=cg.ptc, cg_uc=cg.uc, cg_vc=cg.vc, ut=cg.ut, vt=cg.vt,
            ua=cg.ua, va=cg.va, divg_d=cg.divg_d, xfx=cg.xfx, yfx=cg.yfx,
        )
        if half.zh_c is not None:  # the nonhydrostatic half step
            outs.update(w_x=half.w_x, delz_x=half.delz_x, zh_x=half.zh_x, zh_y=half.zh_y,
                        zh_c=half.zh_c, delz_c=half.delz_c, pe_c=half.pe_c)
        return outs

    for hydrostatic in (True, False):
        label = "C-grid half step" if hydrostatic else "nonhydrostatic C-grid half step"
        small = dict(n=24, npz=8, dtype=torch.float64, hydrostatic=hydrostatic)
        a_half = cdemo.step(cdemo.build_case(device=dev, **small))
        b_case = cdemo.build_case(device="cpu", **small)
        b_half = cdemo.step(b_case)
        a, b = half_outputs(a_half), half_outputs(b_half)
        rel, worst = 0.0, ""
        for nm in a:
            x, y = a[nm][i].cpu(), b[nm][i]
            r = float((x - y).abs().max() / y.abs().max())
            if r > rel:
                rel, worst = r, nm
        if not hydrostatic:
            # ws_c is the difference of two heights over dt2: held to their scale
            r = float((a_half.ws_c[i].cpu() - b_half.ws_c[i]).abs().max()
                      / (b_half.zh_c[i].abs().max() / cdemo.DT2))
            if r > rel:
                rel, worst = r, "ws_c"
        log(f"[check] C24 npz=8 f64 {label}, card kernels vs CPU plain path: max diff "
            f"{rel:.3e} of each output's maximum (largest on {worst or 'none'})")
        if not rel <= 1e-12:
            raise AssertionError(f"C24 f64 {label} departs from the CPU reference: "
                                 f"{rel} on {worst}")
    # the vertical solve's own outputs (the half step keeps only delz and pe
    # + pp of them, and w_new nowhere): the kernel on the card against the
    # plain version on the CPU, on the fields of the CPU's nonhydrostatic
    # half step (the loop's last)
    s_cpu = (b_half.w_x, b_half.zh_c[:, 1:] - b_half.zh_c[:, :-1], b_half.cg.ptc,
             b_half.cg.delpc, b_half.pkz_c, b_half.ws_c)
    ptop24, p_fac24 = b_case.grid.ptop, b_case.config.p_fac
    w_n, dz_n, pp_n = nh_ops.sim1_solver(*s_cpu, b_case.dt2, ptop24)
    dz_n = nh_ops._p_fac_floor(dz_n, *s_cpu[2:5], ptop24, p_fac24)
    s_card = s1k.sim1_solver_cuda(*[t.to(dev).contiguous() for t in s_cpu], b_case.dt2,
                                  ptop24, p_fac=p_fac24)
    check_sim1("C24 npz=8 f64 sim1, card kernel vs CPU plain version",
               [t.cpu() for t in s_card], (w_n, dz_n, pp_n), SIM1_F64_REL_TOL)
    del a, b, a_half, b_half, b_case, s_cpu, s_card, w_n, dz_n, pp_n

    # the substep up to the vertical solve, both configurations. Three
    # outputs of the vertical solve are differences of pressures near 1e5 Pa
    # (the card's log differs from the CPU's by an ulp): pp is held to 1e-12
    # of the largest interface pressure, w to that pressure error times
    # dt / dm of the lightest layer, delz to the w error times dt; ws is the
    # difference of two heights over dt
    def substep_outputs(dhalf):
        names = ["u", "v", "delp", "pt", "mfx", "mfy", "crx", "cry", "xfx", "yfx", "heat"]
        if dhalf.w is not None:
            names += ["w", "delz", "pp", "pk", "pkz", "gz", "ws"]
        outs = {nm: getattr(dhalf, nm) for nm in names}
        outs.update(ds_delp=dhalf.ds.delp, ds_pt=dhalf.ds.pt)
        return outs

    for hydrostatic in (True, False):
        label = f"{'' if hydrostatic else 'non'}hydrostatic substep up to the vertical solve"
        small = dict(n=24, npz=8, dtype=torch.float64, hydrostatic=hydrostatic)
        a = substep_outputs(sdemo.step(sdemo.build_case(device=dev, **small))[1])
        b_case = sdemo.build_case(device="cpu", **small)
        b = substep_outputs(sdemo.step(b_case)[1])
        pe_max = float(b_case.grid.ptop + b_case.state.delp[i].sum(dim=1).max())
        p_err = pe_max * sdemo.DT / (float(b_case.state.delp[i].min()) / constants.GRAV)
        scales = {"pp": pe_max, "w": p_err, "delz": p_err * sdemo.DT}
        rel, worst = 0.0, ""
        for nm in a:
            x, y = ring(a[nm].cpu(), 3), ring(b[nm], 3)
            scale = max(float(y.abs().max()), scales.get(nm, 0.0))
            if nm == "ws":
                scale = float(b["gz"].abs().max()) / constants.GRAV / sdemo.DT
            r = float((x - y).abs().max()) / scale
            if r > rel:
                rel, worst = r, nm
        log(f"[check] C24 npz=8 f64 {label}, card kernels vs CPU plain path: max diff "
            f"{rel:.3e} of each output's scale (largest on {worst or 'none'})")
        if not rel <= 1e-12:
            raise AssertionError(f"C24 f64 {label} departs from the CPU reference: "
                                 f"{rel} on {worst}")
    del a, b, b_case

    # ------------------------------------------------------------------
    # 4. the slice through its entry point, launch counts around it
    # ------------------------------------------------------------------
    counters = {"halo": hk.LAUNCHES, "fvtp2d": fk.LAUNCHES, "fvtp2d_tracer": fk.LAUNCHES,
                "d2a2c": d2k.LAUNCHES, "c_sw_tail": ck.LAUNCHES, "hydro": hyk.LAUNCHES,
                "heights": uzk.LAUNCHES, "updatedz_c": uzk.LAUNCHES, "sim1": s1k.LAUNCHES,
                "fvtp2d_multi": fk.LAUNCHES, "d_sw_tail": dtk.LAUNCHES,
                "flux_height_update": uzk.LAUNCHES}

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

    # --- the C-grid half step through its entry point, in both configurations
    # eight repeats and their median: the second or third repeat can take up
    # to eight times as long as the later ones on the host's clock at
    # unchanged device time. Those are the repeats in which PyTorch's caching
    # allocator still calls cudaMalloc (the previous result is alive
    # while the next is computed); the count per repeat is printed
    c_repeats = 8

    def run_cgrid(tag, hydrostatic):
        """Drive the half step with the counters zeroed before and read after;
        log it and apply the gates both configurations share."""
        zero_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        o = cdemo.run(n=n, npz=npz, repeats=c_repeats, device=dev, dtype=torch.float32,
                      hydrostatic=hydrostatic)
        counts = {k: c[k] for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        o["ms_median"] = statistics.median(o["step_ms"][1:])
        cfg = o["case"].config
        solver = "" if hydrostatic else f" a_imp={cfg.a_imp} p_fac={cfg.p_fac}"
        log(f"[{tag}] C{n} npz={npz} f32 dt2={cdemo.DT2:.4f} s{solver}, {c_repeats} half steps: "
            f"{o['ms_per_half_step']:.3f} ms/half step after the first, median "
            f"{o['ms_median']:.3f} (ms: "
            f"{', '.join(f'{t:.3f}' for t in o['step_ms'])}), device allocations per repeat "
            f"{o['device_allocs']}, peak memory {peak_gb:.2f} GB")
        log(f"[{tag}] finite {o['finite']}, delpc min {o['delpc_min']:.4f}, mass drift "
            f"{o['mass_drift']:.3e}, ptc in [{o['ptc_min']:.4f}, {o['ptc_max']:.4f}] "
            f"(allowed [{o['pt_floor']:.4f}, {o['pt_ceil']:.4f}]), pkz in "
            f"[{o['pkz_min']:.6f}, {o['pkz_max']:.6f}], max|uc| {o['uc_max']:.3f}")
        log(f"[{tag}] launches: {counts}")
        failures = []
        if not o["finite"]:
            failures.append("non-finite fields")
        if not o["delpc_min"] > 0:
            failures.append(f"delpc min {o['delpc_min']}")
        if not o["mass_drift"] <= 1e-6:
            failures.append(f"delpc mass drift {o['mass_drift']}")
        if not (o["pt_floor"] <= o["ptc_min"] and o["ptc_max"] <= o["pt_ceil"]):
            failures.append(f"ptc range [{o['ptc_min']}, {o['ptc_max']}]")
        if not (0 < o["pkz_min"] and o["pkz_max"] < 1.2):
            failures.append(f"pkz range [{o['pkz_min']}, {o['pkz_max']}]")
        return o, counts, failures

    def check_balance(tag, hydrostatic, failures):
        """Balance of the unperturbed (steady) state, after the counts were read."""
        bal = cdemo.steady_state_residual(n, npz, device=dev, dtype=torch.float32,
                                          hydrostatic=hydrostatic)
        log(f"[{tag}] unperturbed state: rms wind tendency {bal['tendency_rms']:.4e} m/s^2, rms "
            f"pressure-gradient term {bal['pgf_rms']:.4e} m/s^2, ratio {bal['ratio']:.4f} "
            f"(allowed {BALANCE_RATIO_MAX})")
        if not 0 < bal["ratio"] <= BALANCE_RATIO_MAX:
            failures.append(f"balance ratio {bal['ratio']}")

    cout, c_launches, failures = run_cgrid("cgrid", hydrostatic=True)
    for k in ("halo", "d2a2c", "c_sw_tail", "hydro"):
        if c_launches[k] <= 0:
            failures.append(f"kernel {k} not launched on the C-grid path")
    check_balance("cgrid", True, failures)
    if failures:
        raise AssertionError("C-grid slice checks failed: " + "; ".join(failures))

    # --- the nonhydrostatic configuration of the dycore benchmark
    nout, n_launches, failures = run_cgrid("nh-cgrid", hydrostatic=False)
    log(f"[nh-cgrid] delz_c max {nout['delz_c_max']:.4f} m, least interface spacing "
        f"{nout['dzh_min']:.4f} m, bottom interface off the surface by {nout['zs_pin_err']:.3e} "
        f"m (from phis/g by {nout['zs_err']:.3e} m), max|pp|/pe {nout['pp_rel_max']:.4e} "
        f"(allowed {PP_REL_MAX}), max|ws_c| {nout['ws_max']:.4e} m/s (allowed {WS_MAX})")
    if not nout["delz_c_max"] < 0:
        failures.append(f"delz_c max {nout['delz_c_max']}")
    if not nout["dzh_min"] > 0:
        failures.append(f"interface heights not decreasing: {nout['dzh_min']}")
    if nout["zs_pin_err"] != 0:
        failures.append(f"bottom interface off the surface by {nout['zs_pin_err']}")
    if not nout["pp_rel_max"] <= PP_REL_MAX:
        failures.append(f"max|pp|/pe {nout['pp_rel_max']}")
    if not nout["ws_max"] <= WS_MAX:
        failures.append(f"max|ws_c| {nout['ws_max']}")
    for k, per_step in NH_LAUNCHES_PER_HALF_STEP.items():
        if n_launches[k] != per_step * c_repeats:
            failures.append(f"kernel {k} launched {n_launches[k]} times, expected "
                            f"{per_step * c_repeats}")
    if n_launches["halo"] <= 0:
        failures.append("kernel halo not launched on the nonhydrostatic C-grid path")
    check_balance("nh-cgrid", False, failures)
    if failures:
        raise AssertionError("nonhydrostatic C-grid slice checks failed: " + "; ".join(failures))

    # --- one acoustic substep as far as it is ported, in the dycore
    #     benchmark's configuration: the C-grid half, d_sw, the heating,
    #     updatedz_d and riem_solver3, through the demo's entry point
    s_repeats = 8
    zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    sout = sdemo.run(n=n, npz=npz, repeats=s_repeats, device=dev, dtype=torch.float32)
    s_launches = {k: c[k] for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_steps = sdemo.WARM_REPEATS + s_repeats
    dcfg = sout["case"].config.d_sw
    log(f"[substep] C{n} npz={npz} f32 dt={sdemo.DT:.4f} s nord={dcfg.nord} d4_bg={dcfg.d4_bg} "
        f"dddmp={dcfg.dddmp} vtdm4={dcfg.vtdm4} d_con={dcfg.d_con}, {s_repeats} substeps after "
        f"{sdemo.WARM_REPEATS} warm ones: mean {sout['ms_per_substep']:.3f} ms/substep, median "
        f"{sout['ms_median']:.3f} (ms: {', '.join(f'{t:.3f}' for t in sout['step_ms'])}), device "
        f"allocations per repeat {sout['device_allocs']}, peak memory {peak_gb:.2f} GB")
    log(f"[substep] finite {sout['finite']}, delp min {sout['delp_min']:.4f}, drift across d_sw "
        f"of mass {sout['mass_drift']:.3e}, of pt mass {sout['theta_drift']:.3e}, of w mass "
        f"{sout['w_drift']:.3e} (allowed {DRIFT_MAX}); pt in [{sout['pt_min']:.4f}, "
        f"{sout['pt_max']:.4f}], max|u| {sout['u_max']:.3f}, max|heat| {sout['heat_max']:.4e} "
        f"J/kg, max|dT| {sout['dT_max']:.4e} K (cap {sout['dT_cap']:.4e})")
    log(f"[substep] delz max {sout['delz_max']:.4f} m, bottom interface off phis/g by "
        f"{sout['zs_err']:.3e} m, max|pp|/pe {sout['pp_rel_max']:.4e} (allowed {PP_REL_MAX}), "
        f"max|ws| {sout['ws_max']:.4e} m/s (allowed {WS_MAX}), max|w| {sout['w_max']:.4e} m/s")
    log(f"[substep] launches in {n_steps} substeps: {s_launches}")
    failures = []
    if not sout["finite"]:
        failures.append("non-finite fields")
    if not sout["delp_min"] > 0:
        failures.append(f"delp min {sout['delp_min']}")
    for k in ("mass_drift", "theta_drift", "w_drift"):
        if not sout[k] <= DRIFT_MAX:
            failures.append(f"{k} {sout[k]}")
    if not 0 < sout["dT_max"] <= sout["dT_cap"] + 2 * ulp * sout["pt_max"]:
        failures.append(f"heating increment {sout['dT_max']} beyond its cap {sout['dT_cap']}")
    if not sout["delz_max"] < 0:
        failures.append(f"delz max {sout['delz_max']}")
    zs_max = float(sout["case"].state.phis.abs().max()) / constants.GRAV
    if not sout["zs_err"] <= 4 * ulp * zs_max:
        failures.append(f"bottom interface off the surface by {sout['zs_err']} m")
    if not sout["pp_rel_max"] <= PP_REL_MAX:
        failures.append(f"max|pp|/pe {sout['pp_rel_max']}")
    if not sout["ws_max"] <= WS_MAX:
        failures.append(f"max|ws| {sout['ws_max']}")
    for k, per_step in LAUNCHES_PER_SUBSTEP.items():
        want = per_step * n_steps + SUBSTEP_SETUP_LAUNCHES.get(k, 0)
        if s_launches[k] != want:
            failures.append(f"kernel {k} launched {s_launches[k]} times, expected {want}")
    for k in ("fvtp2d_tracer",):
        if s_launches[k] != 0:
            failures.append(f"kernel {k} launched on the substep")
    # the unperturbed (steady) state, after the counts were read
    bal = sdemo.steady_state_residual(n, npz, device=dev, dtype=torch.float32)
    log(f"[substep] unperturbed state: rms D-grid wind tendency of d_sw {bal['tendency_rms']:.4e} "
        f"m/s^2, rms C-grid pressure-gradient term {bal['pgf_rms']:.4e} m/s^2, ratio "
        f"{bal['ratio']:.4f} (allowed {D_SW_BALANCE_RANGE})")
    if not D_SW_BALANCE_RANGE[0] <= bal["ratio"] <= D_SW_BALANCE_RANGE[1]:
        failures.append(f"D-grid balance ratio {bal['ratio']}")
    if failures:
        raise AssertionError("substep checks failed: " + "; ".join(failures))

    # ------------------------------------------------------------------
    # 5. where the time goes: two more steps under the profiler (after the
    #    launch counts were read), device time by kernel
    # ------------------------------------------------------------------
    state = {"q": out["q"], "dp": out["delp"]}

    def transport_step():
        state["q"], state["dp"] = demo.step(out["case"], state["q"], state["dp"])

    profile_steps("tracer advection", transport_step, out["ms_per_step"])
    profile_steps("C-grid half step", lambda: cdemo.step(cout["case"]),
                  cout["ms_median"])
    profile_steps("nonhydrostatic C-grid half step", lambda: cdemo.step(nout["case"]),
                  nout["ms_median"])
    profile_steps("substep up to the vertical solve", lambda: sdemo.step(sout["case"]),
                  sout["ms_median"], top=20)

    meta = {
        "halo": ("pace_tpu_torch/csrc/halo.cu", "pace_tpu/parallel/halo_pallas.py:71"),
        "fvtp2d": ("pace_tpu_torch/csrc/fvtp2d.cu", "pace_tpu/ops/fvtp2d_pallas.py:135"),
        "fvtp2d_tracer": ("pace_tpu_torch/csrc/fvtp2d.cu", "pace_tpu/ops/fvtp2d_pallas.py:419"),
        "d2a2c": ("pace_tpu_torch/csrc/d2a2c.cu", "pace_tpu/ops/d2a2c_pallas.py:33"),
        "c_sw_tail": ("pace_tpu_torch/csrc/c_sw_tail.cu", "pace_tpu/ops/c_sw_tail_pallas.py:197"),
        "hydro": ("pace_tpu_torch/csrc/hydro.cu", "pace_tpu/ops/hydro_pallas.py:37"),
        "heights": ("pace_tpu_torch/csrc/updatedz.cu", "pace_tpu/ops/updatedz_pallas.py:52"),
        "updatedz_c": ("pace_tpu_torch/csrc/updatedz.cu", "pace_tpu/ops/updatedz_pallas.py:129"),
        "sim1": ("pace_tpu_torch/csrc/sim1.cu", "pace_tpu/ops/sim1_pallas.py:29"),
        "fvtp2d_multi": ("pace_tpu_torch/csrc/fvtp2d.cu", "pace_tpu/ops/fvtp2d_pallas.py:295"),
        "d_sw_tail": ("pace_tpu_torch/csrc/d_sw_tail.cu", "pace_tpu/ops/d_sw_tail_pallas.py:163"),
        "flux_height_update": ("pace_tpu_torch/csrc/updatedz.cu",
                               "pace_tpu/ops/updatedz_pallas.py:235"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        by_path = {"tracer_advection": launches[name], "cgrid_half_step": c_launches[name],
                   "nh_cgrid_half_step": n_launches[name],
                   "acoustic_substep": s_launches[name]}
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
