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
   halo exactly, the single-field fvtp2d bit-identical to the plain version
   on the consumed region in both of the main path's forms (the corner pack
   here, the heights' full y fold with the D-grid kernels). C-grid slice:
   the new halo plans exactly; d2a2c bit-identical to the plain version on
   the rings a consumer reads (and within 4 ulp of each output's maximum
   there); the c_sw tail within 4 ulp of each output's maximum and
   bit-identical away from the cube corners; the
   hydrostatic chain, whose sums and cancelling differences amplify
   rounding, within three times the plain version's own float32 error,
   measured against its float64 evaluation (see ``check_against_f64``), and
   timed in each form a step launches (``HYDRO_FORMS``).
   Nonhydrostatic vertical, on the fields of one nonhydrostatic half step:
   the interface heights by the same float64 yardstick, ``updatedz_c``
   within 4 ulp of each output's maximum and bit-identical to the plain
   version outside the outer ring, and the vertical solve (sim1) on
   the columns a consumer reads, within 4 ulp of each output's maximum on
   the compute domain in float32 and within ``SIM1_F64_REL_TOL`` of it in
   float64 (see ``check_sim1``), and again at K = 158 and K = 2 on a 5 x 37
   plane of the compute domain, whose column count is no multiple of the
   kernel's tile, in float32 and float64. D-grid half, on the fields of one
   substep: the multi-field transport (and equal to single-field launches
   for every hord, both y-fold forms, four fields and the two fields of
   hydrostatic ``d_sw``), the D-grid tail, the flux-form height update
   and the nonhydrostatic pressure gradient (``nh_p_grad``) within 4 ulp of
   each output's maximum on the compute domain, ``nh_p_grad`` bit-identical
   away from the cube corners and on the seams between the kernel's interior
   and edge tiles. The vertical remap, on the pressure columns after one
   acoustic loop of the dycore step: pt with kord -9, w, the tracer block,
   the u- and v-point winds and the specific volume with kord 9, pt on a
   197 x 199 plane (the ragged last column tile), every kord class at a
   small size in float32 and float64, bit-identical to the plain version,
   with the column integral conserved;
3. small-input references in float64, kernel path on the card against the
   plain path on the CPU: the tracer-advection demo at C24 and the C-grid
   half step at C24 in both configurations, within 1e-12, and the three
   outputs of the vertical solve on that half step's fields; the substep up
   to the vertical solve; one whole dycore step at C24 npz=8 (k_split=2,
   n_split=2) within ``STEP_F64_REL_TOL`` of each field's scale
   (``step_f64_scales``), that step again on the card with the pressure
   gradient's u and v set to NaN outside the compute domain, identical, and
   that step with the total-energy fixer on (``consv_te = 1``), held the
   same way; that step followed by the physics of
   ``examples/configs/baroclinic_c12_physics.yaml`` (GFDL microphysics, PBL
   and shallow convection with its surface fluxes) from the moist tracer
   block of ``demos/physics_step.moist_tracers``, and that step with the
   saturation adjustment (``do_sat_adj``, ``do_qa``), held the same way;
   the same step followed by ``examples/configs/earthlike_c24.yaml``'s
   physics twice (the second call at 200 s), with its surface state and the
   carried precipitation; and four physics sets alone on that step's state,
   two calls each, with their surface states: band radiation over land,
   ``aquaplanet_c24.yaml``'s set with the diurnal and seasonal insolation,
   Held-Suarez and the RJ simple physics (all within 1e-12 of each field's
   scale);
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
   size of the D-grid wind tendency of the unperturbed state); and whole
   dycore steps (``demos/dycore_step.run``) of ``bench.py``'s configuration,
   1 warm and 2 timed steps (the exact launch counts of all fourteen kernels
   per step, finite fields, ``delp > 0``, ``delz < 0``, dry and tracer mass,
   the range of ``ps``, wind bounds), then whole hydrostatic steps with the
   flag set of ``examples/configs/baroclinic_c12.yaml`` (``[step
   hydrostatic]``, ``HYDROSTATIC_STEP_CONFIG``), with the same gates and
   their own exact launch counts, then that run going on with Held-Suarez
   after each step (``[step held_suarez]``, as ``held_suarez_c24.yaml``
   runs it: those gates and launches), then ``bench.py``'s configuration with the
   total-energy fixer on (``[step consv_te]``, ``consv_te = 1``, 1 warm and
   1 timed step: the step's gates, exactly the launches of ``[step]``, the
   fixer's increment of each outer step); then ``bench.py``'s
   ``BENCH_PHYSICS=1`` path (``[step physics]``, ``demos/physics_step.run``:
   each dycore step followed by the GFDL microphysics and the PBL, from the
   moist tracer block; 1 warm and 2 timed steps: the step's gates with the
   tracer drift over the tracers the physics does not touch, exactly the
   launches of ``[step]``, ``delp`` untouched by the physics call, the call
   not writing into its input state, and the water budget of one
   microphysics call within ``WATER_BUDGET_MAX``) and the dycore step with
   the saturation adjustment (``[step sat_adj]``, ``do_sat_adj``, ``do_qa``,
   1 warm and 1 timed step: the step's gates with the drift of the six
   water species' summed mass and of each non-water tracer but ``qcld``,
   ``qcld`` in [0, 1], exactly the launches of ``[step]``);
5. where the time goes: two more steps of each demo under
   ``torch.profiler`` (one of each dycore step with and without the fixer,
   one step with the physics and the physics call alone: its device time,
   its kernel launches and its largest PyTorch kernels), device time by
   kernel;
6. the rest of the physics, after the earlier paths' cases are freed:
   ``[step earthlike]`` (``demos/physics_step.run`` with ``EARTHLIKE``:
   each dycore step followed by ``earthlike_c24.yaml``'s physics, gray
   radiation, the PBL, deep and shallow SAS and the microphysics with
   ``fv_sg_adj = 1800`` over the ``mixed`` surface; 1 warm and 2 timed
   steps: the step gates with the tracer drift over the tracers no scheme
   changes, exactly ``[step]``'s launches, the skin temperature, ice
   thickness and soil moisture in range, the land mask's share equal to
   the share of |lat| <= 55 degrees, the state and surface state a call is
   given not written, one gray radiation call's column energy closure
   within float32 rounding and its OLR; the physics call profiled), and
   three physics calls alone on ``[step earthlike]``'s state (band radiation over
   land with its LW+SW closure and OLR, ``aquaplanet_c24.yaml``'s set, the
   RJ simple physics: each finite, with its wall and device time and
   launches).

The last lines are the card's name and power limit (``nvidia-smi``), the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
#: the hydrostatic chain's forms a step launches: the nonhydrostatic step's
#: C-grid half (pkz) and the pair before riem_solver3 (pk, pkz), 56 each;
#: the hydrostatic step's C-grid half (pk, pkz, gz)
HYDRO_FORMS = (("pkz",), ("pk", "pkz"), ("pk", "pkz", "gz"))

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

# Operations per layer point of the last two kernels:
#   nh_p_grad, per corner and level: four a2b interpolations (x and y
#          4-point stencils, 10 each) 40; per D-grid edge, the hydrostatic
#          pair (term 7, layer thicknesses 3, dt rdl 1, product and
#          quotient 2) and the perturbation pair (term 7, the corner delp
#          sum 1, product and quotient 2) and the two additions to the wind,
#          25, times the two edges = 90;
#   remap, per layer and column: limited or clamped interface value 12, bl
#          and br 2, the selective constraint (both limiters and the noise
#          mask) 30, the coefficients 4, the running integral 3, the
#          location (11 compares and sums) 22, the cubic and its integral 16,
#          the difference and quotient 3 = 92.
PGRAD_OPS_PER_POINT = 90
REMAP_OPS_PER_POINT = 92

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

#: kernel launches of one dycore step (``demos/dycore_step.run``): per
#: acoustic substep (the substep above, plus the D-grid pressure gradient
#: and the final sync of the winds), per outer step (the acoustic loop's
#: exchange of phis, the remap of pt, w, delz, the tracer block, u and v),
#: per tracer sub-cycle (the tracer fluxes and their two exchanges) and
#: once per step (the diagnostics' wind exchange and d2a2c)
STEP_LAUNCHES = {
    "substep": dict(LAUNCHES_PER_SUBSTEP, pgrad=1, halo=46),
    "outer": {"halo": 2, "remap": 6},
    "subcycle": {"fvtp2d_tracer": 1, "halo": 4},
    "step": {"halo": 2, "d2a2c": 1},
}

#: the hydrostatic flag set of examples/configs/baroclinic_c12.yaml
#: (``dycore_config`` and ``dt_atmos``; every other field at its default: no
#: Rayleigh damping, no fill, dynamic tracer sub-cycling), taken at C192
#: npz=79 f32 by the ``[step hydrostatic]`` run
HYDROSTATIC_STEP_CONFIG = dict(k_split=1, n_split=5, hydrostatic=True, nord=1, d4_bg=0.15,
                               hord_mt=6, hord_vt=6, hord_tm=6, hord_dp=6, hord_tr=8)
HYDROSTATIC_STEP_DT = 225.0
#: its kernel launches (counted on the CPU with the wrappers counting, C12):
#: per substep the hydrostatic C-grid half (d2a2c, c_sw tail, the interfaces
#: for p_grad_c) and d_sw (the delp fluxes, pt and vorticity in one
#: multi-field launch, the tail, the interfaces for one_grad_p), per outer
#: step the remap of pt, the tracer block, u and v; no vertical solve
HYDROSTATIC_STEP_LAUNCHES = {
    "substep": {"d2a2c": 1, "c_sw_tail": 1, "hydro": 2, "fvtp2d": 1, "fvtp2d_multi": 1,
                "d_sw_tail": 1, "halo": 35},
    "outer": {"halo": 2, "remap": 4},
    "subcycle": {"fvtp2d_tracer": 1, "halo": 4},
    "step": {"halo": 2, "d2a2c": 1},
}

#: gates of the dycore step from the baroclinic-wave state (``[step]``):
#: relative change of sum(delp area) and of the tracer mass sum(q delp area)
#: over a step (both conserved by the transport and the remap up to
#: rounding; float32 at C24 on the CPU: see PERF.md), the range of the
#: surface pressure [Pa] and the wind bounds [m/s]
STEP_MASS_DRIFT_MAX = 1e-5
PS_RANGE = (9.0e4, 1.06e5)
UV_MAX = 120.0
W_MAX = 10.0

#: the physics of examples/configs/baroclinic_c12_physics.yaml (schemes and
#: shallow-convection surface fluxes), held card against CPU at C24 f64
C12_PHYSICS_SCHEMES = ("GFS_microphysics", "GFS_PBL", "GFS_shallow_convection")
C12_PHYSICS_SHALLOW = dict(sensible_heat_flux=0.02, latent_heat_flux=2.0e-5)
#: the water budget of one microphysics call on the advanced state of
#: ``[step physics]``: |change of the six species' mass + surface
#: precipitation| over the water mass, in float64 over the compute domain.
#: pace_tpu's own float32 budget on the CPU at C24 npz=79 is 3.174e-10
#: (tools/physics_water_budget.py), tighter than this gate.
WATER_BUDGET_MAX = 1e-5
#: [step earthlike]: the compute domain's skin temperature range [K] and
#: the OLR range [W/m^2] of a radiation call on the advanced state
TSKIN_RANGE = (200.0, 340.0)
OLR_RANGE = (150.0, 330.0)
#: the physics sets held alone card against CPU at C24 f64, each over two
#: calls from these model times [s]
PHYSICS_ALONE_TIMES = {"band_radiation, land": 0.0, "aquaplanet, diurnal and seasonal": 1.5e7,
                       "held_suarez": 0.0, "RJ_simple_physics": 0.0}


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
    """Log how many points of ``got`` differ from the plain version at all;
    returns that count."""
    n_diff = int((got != ref).sum())
    log(f"[check] {label}: {n_diff} of {got.numel()} points differ from the plain version"
        + (" (bit-identical)" if n_diff == 0 else ""))
    return n_diff


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


#: fields of the dycore step held card against CPU at C24 f64, within
#: STEP_F64_REL_TOL of each field's scale: its maximum, as the earlier slices
#: held theirs, or, where the ulp-level log difference of the vertical solve
#: propagates, the larger scale of step_f64_scales (see PERF.md); with the
#: saturation adjustment, the cloud fraction in qcld is held on its own to
#: the scale of cloud_fraction_scale
STEP_FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz",
               "omga", "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd")
STEP_F64_REL_TOL = 1e-12


def seeded_tracers(q, seed):
    """A tracer block of ``q``'s shape, dtype and device: uniform in [1e-4,
    1.1e-3] from ``seed``."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    return 1e-3 * (0.1 + torch.rand(q.shape, generator=gen, device=q.device, dtype=q.dtype))


def step_f64_scales(case, constants):
    """Scales of the outputs of the vertical solve: ``w`` is a difference of
    pressures near 1e5 Pa times dt over the lightest layer's mass, ``delz``
    that times dt, ``omga`` the largest interface pressure over the outer
    step (it is a difference of pressures over that time)."""
    st, grid, cfg = case.state, case.grid, case.core.config
    i = (..., slice(grid.n_halo, -grid.n_halo), slice(grid.n_halo, -grid.n_halo))
    pe_max = float(grid.ptop + st.delp[i].sum(dim=1).max())
    dt = case.core.timestep / (cfg.k_split * cfg.n_split)
    p_err = pe_max * dt / (float(st.delp[i].min()) / constants.GRAV)
    return {"w": p_err, "delz": p_err * dt, "omga": pe_max * cfg.k_split / case.core.timestep}


def cloud_fraction_scale(state, dw):
    """The scale of the cloud fraction qcld in the float64 check: its change
    per unit relative change of temperature, rh / dw * T dln(qsat)/dT with
    rh = 1, at most over the compute domain (about 180 at 300 K). The
    cloud fraction (rh - (1 - dw)) / dw divides the relative humidity's
    error by dw = 0.1, and qsat's Clausius-Clapeyron slope multiplies T's:
    an ulp-level difference of the step's temperature between card and CPU
    moves qcld by about 200 times as much as it moves T."""
    from pace_tpu_torch import constants
    from pace_tpu_torch.models.shield.microphysics import T_FREEZE

    qv = state.q[:, constants.TRACER_NAMES.index("qvapor")]
    t = ring(state.pt * state.pkz / (1.0 + constants.ZVIR * qv), 3)
    tc = torch.clamp(t - T_FREEZE, -80.0, 50.0)
    return float((t * 17.502 * 240.97 / (tc + 240.97) ** 2).max()) / dw


#: the fields a physics call changes, held card against CPU
PHYSICS_FIELDS = ("u", "v", "pt", "q", "delp")


def surface_fields(sfc):
    """A SurfaceState's fields by name (``precip``, ``lsm.tskin``, ...);
    empty for none."""
    if sfc is None:
        return {}
    out = {"precip": sfc.precip}
    for part in ("lsm", "ice"):
        sub = getattr(sfc, part)
        if sub is not None:
            out.update({f"{part}.{f.name}": getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})
    return out


def check_physics_f64(label, card, cpu):
    """Each field of ``card`` (name -> tensor on the card) within
    STEP_F64_REL_TOL of the largest value of ``cpu``'s on the compute
    domain, or raise."""
    worst = {}
    for nm, y in cpu.items():
        x, y = ring(card[nm].cpu(), 3), ring(y, 3)
        worst[nm] = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
    log(f"[check] C24 npz=8 f64 {label}, card vs CPU plain path: max diff over each field's "
        "maximum: " + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
    bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
    if bad:
        raise AssertionError(f"C24 f64 {label} departs from the CPU reference: {bad}")


def same_bits(a, b):
    """``a`` and ``b`` hold the same bytes (NaN in ghost columns included)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def column_closure(label, dT, pe, net, dt, t_lay, cp, grav):
    """The column energy closure of one radiation call: cp/g sum(dT dp) / dt
    against the net flux into the column's top minus the net flux out of
    its bottom (``net`` positive downward into the column, at interfaces),
    on the compute domain in float64. The tolerance is float32 rounding:
    4 ulp of T at every level of the column (pt is rounded twice on the
    way, and T from it), and 4 K ulp of the largest flux. Returns (max err,
    tolerance)."""
    eps = torch.finfo(torch.float32).eps
    dp = ring(pe[:, 1:] - pe[:, :-1], 3).double()
    heat = cp / grav * (ring(dT, 3).double() * dp).sum(dim=1) / dt
    flux = ring(net[:, 0] - net[:, -1], 3).double()
    tol = (cp / grav / dt * 4 * eps * (ring(t_lay, 3).double().abs() * dp).sum(dim=1)
           + 4 * pe.shape[1] * eps * float(ring(net, 3).abs().max()))
    err = (heat - flux).abs()
    bad = int((err > tol).sum())
    log(f"[check] {label} column energy closure: max |cp/g sum(dT dp)/dt - net flux "
        f"convergence| {float(err.max()):.4e} W/m^2 (float32 rounding bound at that column "
        f"{float(tol.flatten()[int(err.argmax())]):.4e}, least bound {float(tol.min()):.4e}), "
        f"flux convergence in [{float(flux.min()):.3f}, {float(flux.max()):.3f}] W/m^2; "
        f"{bad} columns beyond their bound")
    if bad:
        raise AssertionError(f"{label}: column energy closure fails at {bad} columns")


def profile_steps(label, step_fn, wall_ms, top=10, calls=2, stats=None):
    """``calls`` calls of ``step_fn`` under torch.profiler: device time by
    kernel per call, the ``top`` largest. Returns the device ms per call
    (None where the profiler recorded none); ``stats``, where given, gets
    the device launches (kernels, copies and sets) per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step_fn()
        torch.cuda.synchronize()
    # device-side kernel events only: the host-side operator events carry
    # their kernels' time too
    rows = [(e.key, e.self_device_time_total / (1e3 * calls), e.count // calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if stats is not None:
        stats["launches"] = sum(r[2] for r in rows)
    if busy > 0:
        log(f"[profile] {label}: device time per step {busy:.3f} ms of {wall_ms:.3f} ms "
            f"wall (busy share {busy / wall_ms:.3f})")
        for name, t, n_calls in rows[:top]:
            log(f"[profile] {t:9.3f} ms {100 * t / busy:5.1f}% x{n_calls:<3d} {name[:90]}")
        return busy
    log(f"[profile] {label}: the profiler recorded no device time: not measured")
    return None


def away_from_cube_corners(grid, shape, device):
    """A boolean mask of ``shape`` (a D-grid tail output, ``(S, K, ., .)``):
    false on the points within one row and column of a cube corner of the
    grid's corner table (any shard), true elsewhere."""
    far = torch.ones(shape[-2:], dtype=torch.bool, device=device)
    for _kind, jj, ii, _own in grid.corner_table:
        far[max(jj - 1, 0):jj + 2, max(ii - 1, 0):ii + 2] = False
    return far.expand(shape)


def consumed(t):
    """The consumed region of an interface flux: all but the outer 3 rows
    and columns (the never-consumed outermost ring and the stencil wrap)."""
    return ring(t, 3)


def check_single_field(label, args):
    """The single-field transport kernel (``fvtp2d_cuda`` on ``args``)
    against its plain version: bit-identical on the consumed region, or
    raise. Returns the max abs error there."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk

    got = fk.fvtp2d_cuda(*args)
    ref = fk.fvtp2d_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for nm, a, b in zip(("fx", "fy"), got, ref):
        a, b = consumed(a), consumed(b)
        e = float((a - b).abs().max())
        n_diff = log_identical(f"fvtp2d {label} {nm} (consumed region; max abs err {e:.3e} of "
                               f"max|flux| {float(b.abs().max()):.3e})", a, b)
        if n_diff:
            raise AssertionError(f"fvtp2d {label} {nm}: {n_diff} points differ from the plain "
                                 f"version")
        err = max(err, e)
    return err


def time_single_field(label, args):
    """``[time]`` of the single-field transport on ``args``: kernel, plain
    version, bound, share of the bound, achieved GB/s of the bound's bytes.
    Returns the kernels line's numbers."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops.folds import CornerPatch

    qx, qy, crx, cry, xfx, yfx, area, hord = args
    ms = time_ms(lambda: fk.fvtp2d_cuda(*args), 20)
    plain_ms = time_ms(lambda: fk.fvtp2d_plain(*args), 3)
    qy_t = qy.data if isinstance(qy, CornerPatch) else qy
    byt = nbytes(qx, qy_t, crx, cry, xfx, yfx, area, crx, cry)  # + fx, fy
    b_ms, b_by = bound(byt, FVTP2D_OPS_PER_POINT[6 if hord == 5 else hord] * qx.numel(),
                       torch.float32)
    log(f"[time] fvtp2d {label} {tuple(qx.shape)} f32 "
        f"({'the corner pack' if isinstance(qy, CornerPatch) else 'a full qy'}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} "
        f"of the kernel's time, {byt / ms / 1e6:.1f} GB/s of the bound's bytes")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def main(device="cuda:0", n=N, npz=NPZ, nq=NQ, steps=STEPS) -> int:
    """The run described above; the arguments exist to rehearse the script
    at a small size, and the card is always required."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    from pace_tpu_torch import _build, constants
    from pace_tpu_torch.demos import acoustic_substep as sdemo
    from pace_tpu_torch.demos import cgrid_half_step as cdemo
    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.demos import physics_step as pdemo
    from pace_tpu_torch.demos import tracer_advection as demo
    from pace_tpu_torch.dtypes import to_tensor
    from pace_tpu_torch.models.fv3 import acoustics
    from pace_tpu_torch.models.fv3.acoustics import acoustic_loop
    from pace_tpu_torch.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
    from pace_tpu_torch.models.shield.microphysics import microphysics_step
    from pace_tpu_torch.models.shield.physics import dycore_to_physics
    from pace_tpu_torch.models.shield import band_radiation as band
    from pace_tpu_torch.models.shield import radiation as rad
    from pace_tpu_torch.models.shield.sas import ShallowConvectionConfig
    from pace_tpu_torch.models.shield.surface import SurfaceConfig
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
    from pace_tpu_torch.ops import pgrad_kernel as pgk
    from pace_tpu_torch.ops import remap_kernel as rmk
    from pace_tpu_torch.ops import remapping as rm_ops
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

    # --- fvtp2d, one field (delp), hord 6 and 8, area-flux weights, the
    #     corner pack: bit-identical to the plain version on the consumed
    #     region (the heights' form, a full qy, with the D-grid kernels below)
    ulp = torch.finfo(torch.float32).eps
    fv_err = 0.0
    for hord in (6, 8):
        args = (dpx, CornerPatch(dpp), crx, cry, xfx, yfx, grid.area, hord)
        fv_err = max(fv_err, check_single_field(f"hord {hord} {tuple(dpx.shape)} the corner "
                                                f"pack", args))
        if hord == 6:
            results["fvtp2d"] = time_single_field("hord 6, delp", args)
    results["fvtp2d"]["max_abs_err"] = fv_err

    # --- fvtp2d tracer block, nq=9, hord 8, mass-flux weights: bit-identical
    #     to the plain version on the consumed region and to single-field
    #     launches tracer by tracer, also at nq=4 and on a ragged 5 x 37 plane
    qx, qp = case.halo.update_scalar_fold_patch(q)
    targs = (qx, CornerPatch(qp), crx, cry, xfx, yfx, grid.area, mfx, mfy, 8)

    def tracer_against_single(label, args):
        got = fk.fvtp2d_tracer_cuda(*args)
        qy = args[1]
        for t in range(args[0].shape[1]):
            qy_t = (CornerPatch(qy.data[:, t].contiguous()) if isinstance(qy, CornerPatch)
                    else qy[:, t].contiguous())
            single = fk.fvtp2d_cuda(args[0][:, t].contiguous(), qy_t, *args[2:7], args[9],
                                    mfx=args[7], mfy=args[8])
            for nm, a, b in zip(("fx", "fy"), got, single):
                if not torch.equal(a[:, t], b):
                    raise AssertionError(f"fvtp2d tracer {label} {nm} tracer {t}: differs from "
                                         f"the single-field launch at "
                                         f"{int((a[:, t] != b).sum())} points")
        log(f"[check] fvtp2d tracer {label}: equal to the single-field launches, tracer by "
            f"tracer, on the whole plane")
        return got

    tr_err = 0.0
    for label, args in ((f"nq={nq} hord 8 {tuple(qx.shape)}", targs),
                        (f"nq=4 hord 8 {tuple(qx[:, :4].shape)}",
                         (qx[:, :4].contiguous(), CornerPatch(qp[:, :4].contiguous()),
                          *targs[2:]))):
        fx, fy = tracer_against_single(label, args)
        rx, ry = fk.fvtp2d_tracer_plain(*args)
        torch.cuda.synchronize()
        for nm, a, b in (("fx", fx, rx), ("fy", fy, ry)):
            a, b = consumed(a), consumed(b)
            e = float((a - b).abs().max())
            scale = float(b.abs().max())
            n_diff = log_identical(f"fvtp2d tracer {label} {nm} (consumed region; max abs err "
                                   f"{e:.3e} of max|flux| {scale:.3e})", a, b)
            if n_diff:
                raise AssertionError(f"fvtp2d tracer {label} {nm}: {n_diff} points differ from "
                                     f"the plain version")
            tr_err = max(tr_err, e)
        del fx, fy, rx, ry
    # a plane that is no multiple of the tile, K = 2, the corner pack (h = 2)
    # and a full y fold
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    sS, sK, sY, sX = 2, 2, 5, 37
    s_ops = (rnd(sS, sK, sY, sX + 1, lo=-0.9, hi=0.9), rnd(sS, sK, sY + 1, sX, lo=-0.9, hi=0.9),
             rnd(sS, sK, sY, sX + 1, lo=-0.2, hi=0.2), rnd(sS, sK, sY + 1, sX, lo=-0.2, hi=0.2),
             rnd(sS, sY, sX, lo=1.0, hi=2.0), rnd(sS, sK, sY, sX + 1), rnd(sS, sK, sY + 1, sX))
    s_q = rnd(sS, 4, sK, sY, sX, lo=0.0, hi=1.0)
    for form, s_qy in (("corner pack h=2", CornerPatch(rnd(sS, 4, sK, 4, 4, lo=0.0, hi=1.0))),
                       ("full y fold", rnd(sS, 4, sK, sY, sX, lo=0.0, hi=1.0))):
        tracer_against_single(f"nq=4 hord 8 {tuple(s_q.shape)} {form}", (s_q, s_qy, *s_ops, 8))
    ms = time_ms(lambda: fk.fvtp2d_tracer_cuda(*targs), 10)
    plain_ms = time_ms(lambda: fk.fvtp2d_tracer_plain(*targs), 2)
    byt = nbytes(qx, qp, crx, cry, xfx, yfx, grid.area, mfx, mfy) + nq * nbytes(crx, cry)
    b_ms, b_by = bound(byt, FVTP2D_OPS_PER_POINT[8] * qx.numel(), torch.float32)
    results["fvtp2d_tracer"] = dict(max_abs_err=tr_err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] fvtp2d tracer hord 8 {tuple(qx.shape)} f32: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the "
        f"kernel's time, {byt / ms / 1e6:.1f} GB/s of the bound's bytes")
    del fxq, fyq, take_idx, qx, qp, s_ops, s_q, targs

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
    # (c_sw reads ring 2), ut, vt on all but the outer three: there the
    # kernel rounds op for op like the plain version, bit for bit
    for nm, a, b, r in zip(("ua", "va", "uc", "vc", "ut", "vt"), d_got, d_ref,
                           (0, 0, 2, 2, 3, 3)):
        a, b = ring(a, r), ring(b, r)
        d_err = max(d_err, check_close(f"d2a2c {nm} (outer {r} rings off)", a, b,
                                       4 * ulp * float(b.abs().max())))
        if log_identical(f"d2a2c {nm} (outer {r} rings off)", a, b):
            raise AssertionError(f"d2a2c {nm}: differs from the plain version on the rings "
                                 f"a consumer reads")
    ms = time_ms(lambda: d2k.d2a2c_cuda(*d_args), 20)
    plain_ms = time_ms(lambda: d2a2c_ops.d2a2c_plain(*d_args), 3)
    d_consts = [getattr(cgrid, f) for f in d2a2c_ops.GRID_FIELDS]
    d_bytes = nbytes(u_y, v_x, *d_consts, *d_got)
    b_ms, b_by = bound(d_bytes, D2A2C_OPS_PER_POINT * d_got[0].numel(), f32)
    results["d2a2c"] = dict(max_abs_err=d_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
    log(f"[time] d2a2c {tuple(u_y.shape)} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's time, "
        f"{d_bytes / ms / 1e6:.1f} GB/s of the bound's bytes")

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
        # bit-identical away from the cube corners (the plain version's
        # three-quadrant mean there is a reciprocal multiply on the card)
        far = away_from_cube_corners(cgrid, a.shape, dev)
        n_far, n_near = int((a != b)[far].sum()), int((a != b)[~far].sum())
        log(f"[check] c_sw tail {nm}: {n_far} of {int(far.sum())} points differ from the plain "
            f"version away from the cube corners, {n_near} of {int((~far).sum())} at them")
        if n_far:
            raise AssertionError(f"c_sw tail {nm}: {n_far} points differ from the plain version "
                                 f"away from the cube corners")
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
    t_bytes = nbytes(*t_args[:14], *t_consts, *t_got)
    log(f"[time] c_sw tail {tuple(delp_x.shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's "
        f"time, {t_bytes / ms / 1e6:.1f} GB/s of the bound's bytes")

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
    step_forms = []
    for need in HYDRO_FORMS:
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
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's time")
        if "gz" not in need:
            step_forms.append((ms, b_ms, b_by))
    plain_ms = time_ms(lambda: pgrad_ops.hydrostatic_interfaces(
        delpc, ptc, st.phis, cgrid.ptop), 3)
    log(f"[time] hydro plain version (all five outputs): {plain_ms:.4f} ms")
    # the line's time and bound: the mean launch of the nonhydrostatic step,
    # which launches each of its two forms once a substep (pkz in the C-grid
    # half, pk and pkz before riem_solver3); max_abs_err: pk's (dimensionless,
    # the pressure gradient's operand)
    results["hydro"] = dict(max_abs_err=h_err["pk"],
                            ms=statistics.mean(f[0] for f in step_forms), plain_ms=plain_ms,
                            bound_ms=statistics.mean(f[1] for f in step_forms),
                            bound_by=step_forms[0][2], library_ms=None)
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
        # the kernel rounds op for op like the plain version (one IEEE
        # division a point): bit-identical outside the unspecified ring
        if log_identical(f"updatedz_c {nm} (outer ring off)", a, b):
            raise AssertionError(f"updatedz_c {nm}: differs from the plain version outside "
                                 f"the outer ring")
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
    # the tiling's limits, f32 and f64: K = 158 (each layer split into two
    # halves of its delp and delz) and K = 2 (the top two layers), on a 5 x 37
    # plane of the compute domain, whose 185 columns are no multiple of the
    # kernel's tile (s1k.tile_columns); every column is consumed there
    def sub_plane(t):
        return t[..., 3:8, 3:40].contiguous()

    halves = [torch.repeat_interleave(t, 2, dim=1) for t in s_args[:5]]
    for j in (1, 3):  # delz, delp
        halves[j] = halves[j] / 2
    limits = {"K=158": [sub_plane(t) for t in halves] + [sub_plane(s_args[5])],
              "K=2": [sub_plane(t[:, :2]) for t in s_args[:5]] + [sub_plane(s_args[5])]}
    del halves
    for label, args32 in limits.items():
        for dtype in (f32, torch.float64):
            args = [t.to(dtype) for t in args32]
            K_ = args[0].shape[1]
            got = s1k.sim1_solver_cuda(*args, dt2, cgrid.ptop, p_fac=p_fac)
            ref = sim1_plain(args)
            torch.cuda.synchronize()
            tol = (dict.fromkeys(("w", "delz", "pp"), 4 * ulp) if dtype == f32
                   else SIM1_F64_REL_TOL)
            for nm, a, b in zip(("w", "delz", "pp"), got, ref):
                check_close(f"sim1 {label} {str(dtype)[6:]} {nm} on a {tuple(a.shape)} plane "
                            f"({s1k.tile_columns(K_, dtype)} columns a block)", a, b,
                            tol[nm] * float(b.abs().max()))
    del limits, args, got, ref
    ms = time_ms(lambda: s1k.sim1_solver_cuda(*s_args, dt2, cgrid.ptop, p_fac=p_fac), 20)
    plain_ms = time_ms(lambda: sim1_plain(s_args), 2)
    b_ms, b_by = bound(nbytes(*s_args, *s_got), SIM1_OPS_PER_POINT * s_args[0].numel(), f32)
    # max_abs_err of the line: pp's [Pa], the pressure gradient's operand
    results["sim1"] = dict(max_abs_err=s_err["pp"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
    log(f"[time] sim1 {tuple(s_args[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's time")
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
    chalf, dhalf = sdemo.step(scase)
    crx, xfx, ut = flux_prep_x(chalf.uc_x, chalf.vc_x, sgrid, dt)
    cry, yfx, vt = flux_prep_y(chalf.uc_y, chalf.vc_y, sgrid, dt)
    vort = d_sw_ops.absolute_vorticity_centers(chalf.u_y, chalf.v_x, sgrid)
    vort_x, vort_p = shalo.update_scalar_fold_patch(vort)
    fl = fvtp2d_best(chalf.delp_x, chalf.delp_y, crx, cry, xfx, yfx, sgrid.area, scfg.hord_dp)
    mfx, mfy = shalo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    del fl
    # the single-field transport's other form on the main path: updatedz_d's
    # interface heights (hord 5, a full qy, K = npz + 1)
    h_args = (chalf.zh_x, chalf.zh_y, *(nh_ops._to_iface(t) for t in (crx, cry, xfx, yfx)),
              sgrid.area, 5)
    check_single_field(f"hord 5 {tuple(chalf.zh_x.shape)} a full qy (the heights)", h_args)
    time_single_field("hord 5, the heights", h_args)
    del h_args
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
    # hydrostatic d_sw's call: pt and the vorticity alone
    p_got = fk.fvtp2d_multi_cuda(trio[:2], *m_args[1:], mfx=mfx, mfy=mfy)
    for (qx, qy, hord, use_mf), pair in zip(trio[:2], p_got):
        kw = dict(mfx=mfx, mfy=mfy) if use_mf else {}
        single = fk.fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, sgrid.area, hord, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(pair[0], single[0]) and torch.equal(pair[1], single[1])):
            raise AssertionError("fvtp2d multi, two fields: differs from the single-field launch")
    log("[check] fvtp2d multi, two fields (pt and vorticity, hydrostatic d_sw's call): equal "
        "to the single-field launches")
    del extra, e_got, single, pair, p_got
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
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's time")
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
            # away from the cube corners, whose energy the plain version
            # divides by 3.0 as a reciprocal multiply: bit-identical
            far = away_from_cube_corners(sgrid, a.shape, a.device)
            n_diff = log_identical(f"d_sw tail ({label}) {nm}, away from the cube corners",
                                   a[far], b[far])
            if n_diff:
                raise AssertionError(f"d_sw tail ({label}) {nm}: {n_diff} points away from the "
                                     f"cube corners differ from the plain version")
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
            t_bytes = nbytes(*t_args[:10], *t_consts, *t_got)
            log(f"[time] d_sw tail {tuple(vort.shape)} f32 nord {tcfg.nord}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the "
                f"kernel's time, {t_bytes / ms / 1e6:.1f} GB/s of the bound's bytes")
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
    del f_got, f_ref, f_args, fl, crx_i, cry_i, xfx_i, yfx_i

    # the nonhydrostatic D-grid pressure gradient on the substep's own
    # operands; held on the compute domain's u and v points (the plain
    # version's pads and rolls leave the outer rings unspecified)
    p_args = (dhalf.u, dhalf.v, dhalf.pk, dhalf.gz, dhalf.pp, dhalf.delp, sgrid, dt)
    p_got = pgk.nh_p_grad_cuda(*p_args)
    p_ref = nh_ops.nh_p_grad(*p_args)
    torch.cuda.synchronize()
    p_err, near_corners = {}, {}
    for nm, a, b in zip(("u", "v"), p_got, p_ref):
        # the wind points next to a cube corner, whose corner value the
        # plain version divides by 3 as a reciprocal multiply
        near = torch.zeros(a.shape[-2:], dtype=torch.bool, device=dev)
        for _kind, jj, ii, _own in sgrid.corner_table:
            if nm == "u":
                near[jj, max(ii - 1, 0):ii + 1] = True
            else:
                near[max(jj - 1, 0):jj + 1, ii] = True
        near_corners[nm] = near
        far = int(ring((a != b) & ~near, 3).sum())
        a, b = ring(a, 3), ring(b, 3)
        p_err[nm] = check_close(f"nh_p_grad {nm} (compute domain)", a, b,
                                4 * ulp * float(b.abs().max()))
        log_identical(f"nh_p_grad {nm}, compute domain", a, b)
        log(f"[check] nh_p_grad {nm}: {far} differing points away from the cube corners")
        if far:
            raise AssertionError(f"nh_p_grad {nm}: {far} points differ away from the cube corners")
    # the seams between the kernel's interior tiles (no blends) and its edge
    # tiles: the u and v points on either side of each boundary between the
    # two classes, held on the compute domain away from the cube corners
    S_, K_, Y_, X_ = dhalf.delp.shape
    edge = pgk.tile_classes(sgrid, S_, Y_, X_)
    TY, TX = pgk.TILE
    for nm, a, b in zip(("u", "v"), p_got, p_ref):
        Yo, Xo = a.shape[-2:]
        cls = edge[:, torch.arange(Yo, device=dev) // TY][:, :, torch.arange(Xo, device=dev) // TX]
        seam = torch.zeros_like(cls)
        seam[:, 1:] |= cls[:, 1:] != cls[:, :-1]
        seam[:, :-1] |= cls[:, :-1] != cls[:, 1:]
        seam[:, :, 1:] |= cls[:, :, 1:] != cls[:, :, :-1]
        seam[:, :, :-1] |= cls[:, :, :-1] != cls[:, :, 1:]
        seam = ring(seam & ~near_corners[nm], 3)[:, None]
        n_seam = int(seam.sum()) * K_
        bad = int(((ring(a, 3) != ring(b, 3)) & seam).sum())
        log(f"[check] nh_p_grad {nm}: {int((~edge).sum())} interior and {int(edge.sum())} edge "
            f"tiles of {TY}x{TX}; {bad} of {n_seam} points on the seams between the two "
            "classes differ from the plain version")
        if bad or (not n_seam and bool(edge.any()) and bool((~edge).any())):
            raise AssertionError(f"nh_p_grad {nm}: {bad} seam points differ ({n_seam} seam points)")
    ms = time_ms(lambda: pgk.nh_p_grad_cuda(*p_args), 20)
    plain_ms = time_ms(lambda: nh_ops.nh_p_grad(*p_args), 3)
    p_consts = [t for _n, t, _s in pgk.grid_operands(sgrid, S_, Y_, X_)]
    p_bytes = nbytes(*p_args[:6], *p_consts, *p_got)
    b_ms, b_by = bound(p_bytes, PGRAD_OPS_PER_POINT * dhalf.delp.numel(), f32)
    results["pgrad"] = dict(max_abs_err=max(p_err.values()), ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] nh_p_grad {tuple(dhalf.delp.shape)} f32: kernel {ms:.4f} ms "
        f"({p_bytes / ms / 1e6:.1f} GB/s of the bound's bytes), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del p_got, p_ref, p_args, p_consts, chalf, dhalf, scase, sgrid, shalo, st
    torch.cuda.empty_cache()

    # --- the vertical remap on the pressure columns of the dycore step after
    #     one acoustic loop from the baroclinic-wave state
    stcase = ddemo.build_case(n, npz, device=dev, dtype=f32)
    sst, dcfg = stcase.state, stcase.core.config
    res = acoustic_loop(sst.u, sst.v, sst.w, sst.delp, sst.pt, sst.phis, stcase.grid,
                        stcase.halo, dcfg.acoustic(), ddemo.TIMESTEP / dcfg.k_split,
                        delz=sst.delz)
    pe1 = torch.cat([torch.full_like(res.delp[:, :1], stcase.grid.ptop),
                     stcase.grid.ptop + torch.cumsum(res.delp, dim=1)], dim=1)
    pe2 = (stcase.grid.ak[None, :, None, None]
           + stcase.grid.bk[None, :, None, None] * pe1[:, -1:])
    qblock = seeded_tracers(sst.q, 0)
    pe1_u, pe2_u = rm_ops.pe_at_u_points(pe1), rm_ops.pe_at_u_points(pe2)
    pe1_v, pe2_v = rm_ops.pe_at_v_points(pe1), rm_ops.pe_at_v_points(pe2)
    # the specific volume, as DynamicalCore._remap remaps it
    spec_vol = res.delz / (pe1[:, 1:] - pe1[:, :-1])

    def column_change(out, q_in, p1, p2):
        """Largest relative change of a column's integral sum(q dp)."""
        dp1, dp2 = (p[..., 1:, :, :] - p[..., :-1, :, :] for p in (p1, p2))
        before = (q_in.double() * dp1.double()).sum(dim=-3)
        after = (out.double() * dp2.double()).sum(dim=-3)
        scale = (q_in.double().abs() * dp1.double()).sum(dim=-3)
        return float(((after - before).abs() / scale).max())

    def check_remap(label, q_in, p1, p2, kord, region):
        got = rmk.remap_cuda(q_in, p1, p2, kord)
        ref = rm_ops.remap_field(q_in, p1, p2, kord)
        torch.cuda.synchronize()
        a, b = region(got), region(ref)
        err = check_close(f"remap {label} kord {kord}", a, b, 4 * torch.finfo(a.dtype).eps
                          * float(b.abs().max()))
        if log_identical(f"remap {label} kord {kord}", a, b):
            raise AssertionError(f"remap {label} kord {kord}: not bit-identical to the plain "
                                 "version")
        K = q_in.shape[-3]
        ch, ch_ref = (column_change(region(o), region(q_in), region(p1), region(p2))
                      for o in (got, ref))
        tol = 4 * K * torch.finfo(a.dtype).eps
        log(f"[check] remap {label} kord {kord}: column integral changes by {ch:.3e} of its "
            f"size at most (plain version {ch_ref:.3e}; tolerance {tol:.3e})")
        if not ch <= tol:
            raise AssertionError(f"remap {label} kord {kord}: column integral changes by {ch}")
        return err

    r_err = {}
    wide = [("pt", res.pt, pe1, pe2, -9, lambda t: ring(t, 3)),
            ("w", res.w, pe1, pe2, 9, lambda t: ring(t, 3)),
            ("tracer block nq=9", qblock, pe1[:, None], pe2[:, None], 9, lambda t: ring(t, 3)),
            ("u", res.u, pe1_u, pe2_u, 9, lambda t: ring(t, 3)),
            ("v", res.v, pe1_v, pe2_v, 9, lambda t: ring(t, 3)),
            ("delz / dp1", spec_vol, pe1, pe2, 9, lambda t: ring(t, 3))]
    for label, q_in, p1, p2, kord, region in wide:
        r_err[label] = check_remap(f"{label} {tuple(q_in.shape)} f32", q_in, p1, p2, kord,
                                   region)
    # a plane of 197 x 199 columns, which is no multiple of the kernel's
    # column tile (and whose rows are not 16-byte aligned): the ragged last
    # tile, on every column
    rag = (slice(None), slice(None), slice(0, 197))
    p1r, p2r, ptr_ = (torch.cat([t[rag], t[rag][..., :1]], -1).contiguous()
                      for t in (pe1, pe2, res.pt))
    r_err["ragged"] = check_remap(f"pt {tuple(ptr_.shape)} f32", ptr_, p1r, p2r, -9, lambda t: t)
    del spec_vol, pe1_v, pe2_v, p1r, p2r, ptr_
    # every kord class and sign at a small size, float32 and float64
    small_gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (f32, torch.float64):
        Ks, shape = 20, (2, 20, 5, 7)
        dps = 50 + 100 * torch.rand(shape, generator=small_gen, device=dev, dtype=dtype)
        p1s = torch.cat([torch.full_like(dps[:, :1], 100.0), 100.0 + torch.cumsum(dps, 1)], 1)
        # target interfaces within a fraction of a layer of the source ones
        eta = torch.sort(torch.linspace(0, 1, Ks + 1, device=dev, dtype=dtype)[1:-1, None, None]
                         + 0.02 * torch.randn((2, Ks - 1, 5, 7), generator=small_gen,
                                              device=dev, dtype=dtype), dim=1).values
        p2s = torch.cat([p1s[:, :1], 100.0 + (p1s[:, -1:] - 100.0) * eta, p1s[:, -1:]], 1)
        qs = (torch.sin(torch.arange(Ks, device=dev, dtype=dtype))[None, :, None, None]
              + 0.3 * torch.randn(shape, generator=small_gen, device=dev, dtype=dtype))
        for kord in (6, 7, 8, 9, 10, -6, -7, -8, -9, -10):
            check_remap(f"{tuple(shape)} {str(dtype)[6:]}", qs, p1s, p2s, kord, lambda t: t)
    # timed at the main path's calls: one field and the tracer block
    ms = time_ms(lambda: rmk.remap_cuda(res.pt, pe1, pe2, -9), 20)
    plain_ms = time_ms(lambda: rm_ops.remap_field(res.pt, pe1, pe2, -9), 3)
    b_ms, b_by = bound(nbytes(res.pt, pe1, pe2, res.pt), REMAP_OPS_PER_POINT * res.pt.numel(),
                       f32)
    ms_q = time_ms(lambda: rmk.remap_cuda(qblock, pe1[:, None], pe2[:, None], 9), 5)
    bq_ms, bq_by = bound(nbytes(qblock, pe1, pe2, qblock),
                         REMAP_OPS_PER_POINT * qblock.numel(), f32)
    # max_abs_err of the line: pt's [K]
    results["remap"] = dict(max_abs_err=r_err["pt"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, tracer_block_ms=ms_q,
                            tracer_block_bound_ms=bq_ms)
    log(f"[time] remap {tuple(res.pt.shape)} f32 kord -9: kernel {ms:.4f} ms "
        f"({nbytes(res.pt, pe1, pe2, res.pt) / ms / 1e6:.1f} GB/s of the bound's bytes), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); tracer block "
        f"{tuple(qblock.shape)} kord 9: kernel {ms_q:.4f} ms "
        f"({nbytes(qblock, pe1, pe2, qblock) / ms_q / 1e6:.1f} GB/s), bound {bq_ms:.4f} ms "
        f"({bq_by})")
    del res, pe1, pe2, pe1_u, pe2_u, qblock, wide, stcase, sst
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

    # one whole dycore step with the benchmark's flags at k_split=2,
    # n_split=2, held per field (STEP_F64_REL_TOL of step_f64_scales)
    small = dict(n=24, npz=8, dtype=torch.float64, k_split=2, n_split=2)
    a_case = ddemo.build_case(device=dev, **small)
    b_case = ddemo.build_case(device="cpu", **small)
    # tracers to transport and remap (the baroclinic-wave state has none)
    b_case.state.q = seeded_tracers(b_case.state.q, 2)
    a_case.state.q = b_case.state.q.to(dev)
    q_step = a_case.state.q.clone()
    a_st = a_case.core.step_dynamics(a_case.state)
    b_st = b_case.core.step_dynamics(b_case.state)
    scales = step_f64_scales(b_case, constants)
    worst = {}
    for nm in STEP_FIELDS:
        x, y = ring(getattr(a_st, nm).cpu(), 3), ring(getattr(b_st, nm), 3)
        scale = max(float(y.abs().max()), scales.get(nm, 0.0))
        worst[nm] = float((x - y).abs().max()) / scale
    log("[check] C24 npz=8 f64 dycore step (k_split=2, n_split=2), card kernels vs CPU plain "
        "path, max diff over each field's scale: "
        + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
    bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
    if bad:
        raise AssertionError(f"C24 f64 dycore step departs from the CPU reference: {bad}")
    # the pressure gradient's u and v outside the compute domain, where the
    # kernel's clamped reads and the plain version's pads part, are never
    # read: the same step with them poisoned by NaN gives the same state
    p_case = ddemo.build_case(device=dev, **small)
    p_case.state.q = q_step.clone()
    orig_pgrad = acoustics.nh_p_grad_best

    def poisoned_pgrad(*args, **kw):
        outs = []
        for t in orig_pgrad(*args, **kw):
            keep = ring(t, 3).clone()
            t = torch.full_like(t, float("nan"))
            t[..., 3:t.shape[-2] - 3, 3:t.shape[-1] - 3] = keep
            outs.append(t)
        return tuple(outs)

    acoustics.nh_p_grad_best = poisoned_pgrad
    try:
        p_st = p_case.core.step_dynamics(p_case.state)
    finally:
        acoustics.nh_p_grad_best = orig_pgrad
    differ = [nm for nm in STEP_FIELDS
              if not torch.equal(ring(getattr(p_st, nm), 3), ring(getattr(a_st, nm), 3))]
    log("[check] C24 npz=8 f64 dycore step with nh_p_grad's u, v outside the compute domain "
        f"set to NaN: {len(STEP_FIELDS) - len(differ)} of {len(STEP_FIELDS)} fields identical "
        f"to the step without{': ' + ', '.join(differ) if differ else ''}")
    if differ:
        raise AssertionError(f"the step reads nh_p_grad's ghost columns: {differ}")
    del a_case, a_st, b_st, p_case, p_st

    # the same step with the total-energy fixer on (te1 before the remap, te2,
    # the global increment of each outer step and pt += dT / pkz after it),
    # held the same way
    def check_step_f64(label, card, cpu, note="", qcld_scale=None):
        """Each of STEP_FIELDS of the card's state within STEP_F64_REL_TOL
        of its scale of the CPU's, on the compute domain, or raise. With
        ``qcld_scale``, the tracer block is held without qcld, and qcld on
        its own to the larger of its maximum and ``qcld_scale``."""
        pairs = {nm: (getattr(card, nm).cpu(), getattr(cpu, nm), scales.get(nm, 0.0))
                 for nm in STEP_FIELDS}
        if qcld_scale is not None:
            ic = constants.TRACER_NAMES.index("qcld")
            keep = [k for k in range(len(constants.TRACER_NAMES)) if k != ic]
            x, y, _ = pairs["q"]
            pairs["q"] = (x[:, keep], y[:, keep], 0.0)
            pairs["qcld"] = (x[:, ic], y[:, ic], qcld_scale)
        worst = {}
        for nm, (x, y, extra) in pairs.items():
            x, y = ring(x, 3), ring(y, 3)
            scale = max(float(y.abs().max()), extra)
            worst[nm] = float((x - y).abs().max()) / scale
        log(f"[check] C24 npz=8 f64 {label} (k_split=2, n_split=2), card kernels vs CPU plain "
            f"path: {note}max diff over each field's scale: "
            + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
        bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
        if bad:
            raise AssertionError(f"C24 f64 {label} departs from the CPU reference: {bad}")

    e_cases = [ddemo.build_case(device=d, consv_te=1.0, **small) for d in (dev, "cpu")]
    for c in e_cases:
        c.state.q = q_step.to(c.state.q.device)
    e_card, e_cpu = (c.core.step_dynamics(c.state) for c in e_cases)
    e_dT = [[float(t) for t in c.core.energy_fix_dT] for c in e_cases]
    check_step_f64("dycore step with consv_te=1", e_card, e_cpu,
                   f"increments dT {e_dT[0]} K on the card, {e_dT[1]} K on the CPU; ")
    del b_case, q_step, e_cases, e_card, e_cpu

    # the step followed by the physics of baroclinic_c12_physics.yaml, from
    # the moist tracer block, so that the shallow plume fires
    phys_kw = dict(sas_config=ShallowConvectionConfig(**C12_PHYSICS_SHALLOW))
    p_cases = [pdemo.build_case(device=d, schemes=C12_PHYSICS_SCHEMES, physics_kw=phys_kw,
                                **small) for d in (dev, "cpu")]
    stepped = [c.core.step_dynamics(c.state) for c in p_cases]
    p_card, p_cpu = (c.physics(st) for c, st in zip(p_cases, stepped))
    check_step_f64(f"dycore step and Physics({', '.join(C12_PHYSICS_SCHEMES)})", p_card, p_cpu)
    # the same step followed by earthlike_c24.yaml's physics twice (the
    # second call 200 s on), with its surface state and carried precipitation
    t_phys = time.perf_counter()
    e_phys = [pdemo.make_physics(c.grid, **pdemo.EARTHLIKE) for c in p_cases]
    e_card, e_cpu = (ph(ph(st, 0.0), ddemo.TIMESTEP) for ph, st in zip(e_phys, stepped))
    check_step_f64("dycore step and earthlike_c24.yaml's Physics twice", e_card, e_cpu)
    check_physics_f64("earthlike_c24.yaml's Physics twice after the step: its surface state",
                      surface_fields(e_phys[0].surface_state),
                      surface_fields(e_phys[1].surface_state))
    # four physics sets alone on the stepped state, two calls each
    alone = {
        "band_radiation, land": dict(schemes=("band_radiation",),
                                     surface_config=SurfaceConfig(type="land")),
        "aquaplanet, diurnal and seasonal": dict(pdemo.AQUAPLANET, physics_kw=dict(
            pdemo.AQUAPLANET["physics_kw"], radiation_config=rad.GrayRadiationConfig(
                interactive_vapor=True, diurnal=True, seasonal=True))),
        "held_suarez": dict(schemes=("held_suarez",)),
        "RJ_simple_physics": dict(schemes=("RJ_simple_physics",)),
    }
    for label, kw in alone.items():
        t0 = PHYSICS_ALONE_TIMES[label]
        outs = []
        for c, st in zip(p_cases, stepped):
            ph = pdemo.make_physics(c.grid, **kw)
            st = ph(ph(st, t0), t0 + ddemo.TIMESTEP)
            outs.append({**{f: getattr(st, f) for f in PHYSICS_FIELDS},
                         **surface_fields(ph.surface_state)})
        check_physics_f64(f"Physics {label}, two calls from t = {t0:.0f} s", *outs)
    log(f"[wall] the C24 f64 checks of the radiation, surface, Held-Suarez and RJ physics took "
        f"{time.perf_counter() - t_phys:.1f} s")
    del p_cases, p_card, p_cpu, stepped, e_phys, e_card, e_cpu, outs
    # the step with the saturation adjustment and the cloud fraction
    s_cases = [ddemo.build_case(device=d, do_sat_adj=True, do_qa=True, **small)
               for d in (dev, "cpu")]
    for c in s_cases:
        c.state.q = to_tensor(pdemo.moist_tracers(c.state), c.state.q.device, c.state.q.dtype)
    s_card, s_cpu = (c.core.step_dynamics(c.state) for c in s_cases)
    check_step_f64("dycore step with do_sat_adj, do_qa", s_card, s_cpu,
                   qcld_scale=cloud_fraction_scale(s_cpu, s_cases[1].core.config.dw_ocean))
    del s_cases, s_card, s_cpu

    # ------------------------------------------------------------------
    # 4. the slice through its entry point, launch counts around it
    # ------------------------------------------------------------------
    counters = {"halo": hk.LAUNCHES, "fvtp2d": fk.LAUNCHES, "fvtp2d_tracer": fk.LAUNCHES,
                "d2a2c": d2k.LAUNCHES, "c_sw_tail": ck.LAUNCHES, "hydro": hyk.LAUNCHES,
                "heights": uzk.LAUNCHES, "updatedz_c": uzk.LAUNCHES, "sim1": s1k.LAUNCHES,
                "fvtp2d_multi": fk.LAUNCHES, "d_sw_tail": dtk.LAUNCHES,
                "flux_height_update": uzk.LAUNCHES, "pgrad": pgk.LAUNCHES,
                "remap": rmk.LAUNCHES}

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

    # --- whole dycore steps through the demo's entry point, with a seeded
    #     tracer block to conserve: bench.py's configuration, then the
    #     hydrostatic flag set of examples/configs/baroclinic_c12.yaml
    def run_steps(tag, step_case, tables, warm=1, timed=2, runner=ddemo.run,
                  tracer_groups=None):
        """``warm`` + ``timed`` steps of ``step_case`` through ``runner`` with
        the launch counters set to 0 just before and read just after; the
        launches held to ``tables`` exactly, the state to the step gates, the
        tracer mass drift taken over each group of ``tracer_groups`` (name ->
        tracer indices; without it, over the whole block, which is first
        seeded by ``seeded_tracers``). Returns the demo's result and the
        launches."""
        if tracer_groups is None:
            step_case.state.q = seeded_tracers(step_case.state.q, 3)
            tracer_groups = {"tracer": list(range(len(constants.TRACER_NAMES)))}
        sgrid = step_case.grid
        i = (..., slice(sgrid.n_halo, -sgrid.n_halo), slice(sgrid.n_halo, -sgrid.n_halo))
        area = sgrid.area[i].double()[:, None]

        def masses(st):
            dm = st.delp[i].double() * area
            return float(dm.sum()), {g: float((st.q[:, idx][i].double() * dm[:, None]).sum())
                                     for g, idx in tracer_groups.items()}

        m0, qm0 = masses(step_case.state)
        zero_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        stout = runner(case=step_case, warm=warm, steps=timed)
        st_launches = {k: c[k] for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        n_steps = warm + timed
        fst = step_case.state
        m1, qm1 = masses(fst)
        n_sub = sum(sum(s_) for s_ in stout["tracer_subcycles"])
        cfg_ = step_case.core.config
        per = {"substep": n_steps * cfg_.k_split * cfg_.n_split,
               "outer": n_steps * cfg_.k_split, "subcycle": n_sub, "step": n_steps}
        want = {k: 0 for k in counters}
        for kind, table in tables.items():
            for k, v in table.items():
                want[k] += v * per[kind]
        stats = {
            "finite": all(bool(torch.isfinite(getattr(fst, f)[i]).all())
                          for f in ("u", "v", "w", "delp", "pt", "delz", "q", "ps")),
            "delp_min": float(fst.delp[i].min()), "delz_max": float(fst.delz[i].max()),
            "mass_drift": abs(m1 - m0) / m0,
            "tracer_drift": {g: abs(qm1[g] - qm0[g]) / qm0[g] for g in tracer_groups},
            "ps_min": float(fst.ps[i].min()), "ps_max": float(fst.ps[i].max()),
            "uv_max": max(float(fst.u[i].abs().max()), float(fst.v[i].abs().max())),
            "w_max": float(fst.w[i].abs().max()), "pt_min": float(fst.pt[i].min()),
            "pt_max": float(fst.pt[i].max()),
        }
        log(f"[{tag}] C{n} npz={npz} f32 dt={step_case.core.timestep:.0f} s "
            f"hydrostatic={cfg_.hydrostatic} k_split={cfg_.k_split} n_split={cfg_.n_split} "
            f"nord={cfg_.nord} d2_bg_k1={cfg_.d2_bg_k1} d2_bg_k2={cfg_.d2_bg_k2} "
            f"d4_bg={cfg_.d4_bg}, {timed} steps after {warm} warm: "
            f"{stout['ms_per_step']:.3f} ms/step (ms: "
            f"{', '.join(f'{t:.3f}' for t in stout['step_ms'])}), "
            f"{stout['gridpoints_per_s']:.1f} grid-point updates/s, peak memory {peak_gb:.2f} "
            f"GB, tracer sub-cycles per outer step {stout['tracer_subcycles']}")
        log(f"[{tag}] after {n_steps} steps: finite {stats['finite']}, delp min "
            f"{stats['delp_min']:.4f} Pa, delz max {stats['delz_max']:.4f} m, drift of dry mass "
            f"{stats['mass_drift']:.3e} and of "
            + ", ".join(f"{g} mass {d:.3e}" for g, d in stats["tracer_drift"].items())
            + f" (allowed {STEP_MASS_DRIFT_MAX}), ps in [{stats['ps_min']:.1f}, "
            f"{stats['ps_max']:.1f}] Pa (allowed {PS_RANGE}), max|u|,|v| {stats['uv_max']:.3f} "
            f"m/s (allowed {UV_MAX}), max|w| {stats['w_max']:.4e} m/s (allowed {W_MAX}), pt in "
            f"[{stats['pt_min']:.3f}, {stats['pt_max']:.3f}] K")
        log(f"[{tag}] launches in {n_steps} steps: {st_launches}")
        failures = []
        if cfg_.consv_te > 0:
            log(f"[{tag}] energy fixer increment of each outer step [K], step by step: "
                + "; ".join(", ".join(f"{t:.6f}" for t in dts) for dts in stout["energy_fix_dT"]))
            dts = [t for step_dts in stout["energy_fix_dT"] for t in step_dts]
            if len(dts) != n_steps * cfg_.k_split or not all(abs(t) < float("inf") for t in dts):
                failures.append(f"energy fixer increments {stout['energy_fix_dT']}")
        if not stats["finite"]:
            failures.append("non-finite fields")
        if not stats["delp_min"] > 0:
            failures.append(f"delp min {stats['delp_min']}")
        if not stats["delz_max"] < 0:
            failures.append(f"delz max {stats['delz_max']}")
        for k, d in [("mass_drift", stats["mass_drift"])] + [
                (f"{g} mass drift", d) for g, d in stats["tracer_drift"].items()]:
            if not d <= STEP_MASS_DRIFT_MAX:
                failures.append(f"{k} {d}")
        if not PS_RANGE[0] <= stats["ps_min"] <= stats["ps_max"] <= PS_RANGE[1]:
            failures.append(f"ps range [{stats['ps_min']}, {stats['ps_max']}]")
        if not stats["uv_max"] <= UV_MAX:
            failures.append(f"max|u|,|v| {stats['uv_max']}")
        if not stats["w_max"] <= W_MAX:
            failures.append(f"max|w| {stats['w_max']}")
        for k, c in want.items():
            if st_launches[k] != c:
                failures.append(f"kernel {k} launched {st_launches[k]} times, expected {c}")
        if failures:
            raise AssertionError(f"{tag} checks failed: " + "; ".join(failures))
        return stout, st_launches

    # build_case applies the demo's STABLE_DAMPING: with bench.py's divergence
    # damping the step diverges from this state (ROADMAP queue 3); the change
    # is to coefficients only, no operation or launch
    step_case = ddemo.build_case(n, npz, device=dev, dtype=f32)
    stout, st_launches = run_steps("step", step_case, STEP_LAUNCHES)
    missing = [k for k, c in st_launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not on the dycore step's path: {missing}")
    h_case = ddemo.build_case(n, npz, device=dev, dtype=f32)
    h_case.core = DynamicalCore(h_case.grid, h_case.halo,
                                DynamicalCoreConfig(npz=npz, **HYDROSTATIC_STEP_CONFIG),
                                timestep=HYDROSTATIC_STEP_DT)
    h_out, h_launches = run_steps("step hydrostatic", h_case, HYDROSTATIC_STEP_LAUNCHES)
    # Held-Suarez behind the same step, as held_suarez_c24.yaml runs it: cell
    # 5's run goes on with the forcing after each step
    t_phys = time.perf_counter()
    hs_case = pdemo.PhysicsCase(
        **{f.name: getattr(h_case, f.name) for f in dataclasses.fields(h_case)},
        physics=pdemo.make_physics(h_case.grid, schemes=("held_suarez",),
                                   timestep=HYDROSTATIC_STEP_DT))
    hs_out, hs_launches = run_steps("step held_suarez", hs_case, HYDROSTATIC_STEP_LAUNCHES,
                                    runner=pdemo.run)
    log(f"[step held_suarez] physics call {hs_out['physics_ms_per_step']:.3f} ms/step of wall "
        f"time within {hs_out['ms_per_step']:.3f} ms/step, against {h_out['ms_per_step']:.3f} "
        f"ms/step of [step hydrostatic]; the block took {time.perf_counter() - t_phys:.1f} s")
    del h_case, hs_case
    # bench.py's configuration with the total-energy fixer on: the same
    # kernels, the same launches a step
    e_case = ddemo.build_case(n, npz, device=dev, dtype=f32, consv_te=1.0)
    e_out, e_launches = run_steps("step consv_te", e_case, STEP_LAUNCHES, warm=1, timed=1)
    log(f"[step consv_te] {e_out['ms_per_step']:.3f} ms/step of wall time against "
        f"{stout['ms_per_step']:.3f} ms/step of [step]")

    # bench.py's BENCH_PHYSICS=1 path: each dycore step followed by the GFDL
    # microphysics and the PBL, from the moist tracer block. The physics
    # moves water between the six species and lets it fall out, so the
    # tracer drift is taken over each of the other tracers.
    names = constants.TRACER_NAMES
    water = [names.index(nm) for nm in
             ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")]
    dry_tracers = {nm: [k] for k, nm in enumerate(names) if k not in water}
    torch.cuda.empty_cache()
    p_case = pdemo.build_case(n, npz, device=dev, dtype=f32)
    p_out, p_launches = run_steps("step physics", p_case, STEP_LAUNCHES, runner=pdemo.run,
                                  tracer_groups=dry_tracers)
    log(f"[step physics] physics call {p_out['physics_ms_per_step']:.3f} ms/step of wall time "
        f"(ms: {', '.join(f'{t:.3f}' for t in p_out['physics_ms'])}) within "
        f"{p_out['ms_per_step']:.3f} ms/step of the whole step, against "
        f"{stout['ms_per_step']:.3f} ms/step of [step]")
    # one more call: delp bit for bit, and the state it is given not written
    # (compared as bytes: the ghost columns may hold NaN)
    p_in = p_case.state
    before = {f: getattr(p_in, f).clone() for f in ("u", "v", "w", "delz", "pt", "q", "delp")}
    p_after = p_case.physics(p_in)
    delp_same = same_bits(p_after.delp, before["delp"])
    written = [f for f, t in before.items() if not same_bits(getattr(p_in, f), t)]
    del p_after, before
    # the water budget of one microphysics call on the advanced state
    phy = dycore_to_physics(p_in)
    species = [getattr(phy, nm) for nm in
               ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")]
    mp_out = microphysics_step(*species, phy.pt, phy.p_mid, phy.delp, ddemo.TIMESTEP,
                               p_case.physics.config)
    budget, w_mass, p_mass = pdemo.water_budget(species, mp_out[:6], mp_out[7], phy.delp,
                                                p_case.grid.area, p_case.grid.n_halo)
    del phy, species, mp_out
    log(f"[step physics] the physics call leaves delp bit for bit: {delp_same}; fields of its "
        f"input state written: {written or 'none'}; water budget of one microphysics call "
        f"|dM + P| / M {budget:.3e} (allowed {WATER_BUDGET_MAX}; water {w_mass:.6e} kg, "
        f"precipitated {p_mass:.6e} kg)")
    if not (delp_same and not written and budget <= WATER_BUDGET_MAX):
        raise AssertionError(f"[step physics] checks failed: delp kept {delp_same}, input "
                             f"fields written {written}, water budget {budget}")

    # bench.py's configuration with the saturation adjustment and the cloud
    # fraction: water moves between the six species, qcld is overwritten
    s_case = ddemo.build_case(n, npz, device=dev, dtype=f32, do_sat_adj=True, do_qa=True)
    s_case.state.q = to_tensor(pdemo.moist_tracers(s_case.state), dev, f32)
    s_groups = {"water": water, **{nm: k for nm, k in dry_tracers.items() if nm != "qcld"}}
    sa_out, sa_launches = run_steps("step sat_adj", s_case, STEP_LAUNCHES, warm=1, timed=1,
                                    tracer_groups=s_groups)
    qcld = s_case.state.q[:, names.index("qcld"), :, 3:-3, 3:-3]
    qcld_range = (float(qcld.min()), float(qcld.max()))
    log(f"[step sat_adj] {sa_out['ms_per_step']:.3f} ms/step of wall time against "
        f"{stout['ms_per_step']:.3f} ms/step of [step]; qcld in [{qcld_range[0]:.4f}, "
        f"{qcld_range[1]:.4f}] (allowed [0, 1])")
    if not 0.0 <= qcld_range[0] <= qcld_range[1] <= 1.0:
        raise AssertionError(f"[step sat_adj] qcld range {qcld_range}")
    del s_case, qcld

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

    def dycore_step():
        step_case.state = step_case.core.step_dynamics(step_case.state)

    step_dev = profile_steps("dycore step", dycore_step, stout["ms_per_step"], top=30, calls=1)

    def dycore_step_consv_te():
        e_case.state = e_case.core.step_dynamics(e_case.state)

    e_dev = profile_steps("dycore step consv_te", dycore_step_consv_te, e_out["ms_per_step"],
                          top=10, calls=1)
    if step_dev is not None and e_dev is not None:
        log(f"[step consv_te] device time {e_dev:.3f} ms/step against {step_dev:.3f} ms/step "
            f"of [step]")
    del e_case

    def dycore_step_physics():
        p_case.state = p_case.physics(p_case.core.step_dynamics(p_case.state))

    pstep_dev = profile_steps("dycore step physics", dycore_step_physics, p_out["ms_per_step"],
                              top=15, calls=1)
    p_in, phys_stats = p_case.state, {}
    phys_dev = profile_steps("physics call", lambda: p_case.physics(p_in),
                             p_out["physics_ms_per_step"], top=15, calls=1, stats=phys_stats)

    def ms(t):
        return "not measured" if t is None else f"{t:.3f} ms"

    log(f"[step physics] physics call: device time {ms(phys_dev)} against "
        f"{p_out['physics_ms_per_step']:.3f} ms of wall time, {phys_stats.get('launches')} "
        f"device launches (kernels, copies and sets) a call; the step with the physics: device "
        f"time {ms(pstep_dev)} against {ms(step_dev)} of [step]")
    del p_case, p_in

    # ------------------------------------------------------------------
    # 6. the rest of the physics, after the earlier paths' cases are freed:
    #    earthlike_c24.yaml's physics behind the dycore step, Held-Suarez
    #    behind the hydrostatic step, three physics calls alone
    # ------------------------------------------------------------------
    del step_case, out, cout, nout, sout
    torch.cuda.empty_cache()
    t_phys = time.perf_counter()
    el_case = pdemo.build_case(n, npz, device=dev, dtype=f32, **pdemo.EARTHLIKE)
    el_out, el_launches = run_steps("step earthlike", el_case, STEP_LAUNCHES, runner=pdemo.run,
                                    tracer_groups=dry_tracers)
    el_ph = el_case.physics
    log(f"[step earthlike] physics call {el_out['physics_ms_per_step']:.3f} ms/step of wall "
        f"time (ms: {', '.join(f'{t:.3f}' for t in el_out['physics_ms'])}) within "
        f"{el_out['ms_per_step']:.3f} ms/step of the whole step, against "
        f"{stout['ms_per_step']:.3f} ms/step of [step] and {p_out['physics_ms_per_step']:.3f} "
        f"ms of [step physics]'s physics call")
    # the surface after three calls, on the compute domain
    sfc = el_ph.surface_state
    lsm_cfg, _ = el_ph._surface.cfg
    diag = el_ph._surface.diagnostics(sfc)
    tskin = ring(diag["tskin"], 3)
    h_ice = ring(sfc.ice.h_ice, 3)
    smc = ring(sfc.lsm.smc, 3)
    land = ~torch.isnan(ring(diag["soil_moisture"], 3))
    lat = ring(el_case.grid.lat_agrid, 3)
    band_cells = int((lat.abs() <= math.radians(el_ph.surface_config.land_lat_max)).sum())
    log(f"[step earthlike] surface after {el_case.time_seconds:.0f} s: tskin in "
        f"[{float(tskin.min()):.3f}, {float(tskin.max()):.3f}] K (allowed {TSKIN_RANGE}), h_ice "
        f"in [{float(h_ice.min()):.4f}, {float(h_ice.max()):.4f}] m, soil moisture in "
        f"[{float(smc.min()):.4f}, {float(smc.max()):.4f}] (allowed [0, {lsm_cfg.smcmax}]), "
        f"carried precipitation up to {float(ring(sfc.precip, 3).max()):.4e} kg/m^2/s; land "
        f"cells {int(land.sum())} of {land.numel()}, cells with |lat| <= "
        f"{el_ph.surface_config.land_lat_max} deg {band_cells}")
    failures = []
    if not (bool(torch.isfinite(tskin).all())
            and TSKIN_RANGE[0] <= float(tskin.min()) <= float(tskin.max()) <= TSKIN_RANGE[1]):
        failures.append(f"tskin range [{float(tskin.min())}, {float(tskin.max())}]")
    if not float(h_ice.min()) >= 0.0:
        failures.append(f"h_ice min {float(h_ice.min())}")
    if not 0.0 <= float(smc.min()) <= float(smc.max()) <= lsm_cfg.smcmax:
        failures.append(f"soil moisture range [{float(smc.min())}, {float(smc.max())}]")
    if int(land.sum()) != band_cells:
        failures.append(f"land cells {int(land.sum())}, |lat| <= max cells {band_cells}")
    # one more call: delp bit for bit, and neither the state nor the surface
    # state it is given written
    el_in, sfc_in = el_case.state, sfc
    before = {f: getattr(el_in, f).clone() for f in ("u", "v", "w", "delz", "pt", "q", "delp")}
    sfc_before = {k: v.clone() for k, v in surface_fields(sfc_in).items()}
    el_after = el_ph(el_in, el_case.time_seconds)
    delp_same = same_bits(el_after.delp, before["delp"])
    written = ([f for f, t in before.items() if not same_bits(getattr(el_in, f), t)]
               + [k for k, t in sfc_before.items() if not same_bits(surface_fields(sfc_in)[k], t)])
    log(f"[step earthlike] the physics call leaves delp bit for bit: {delp_same}; fields of its "
        f"input state and surface state written: {written or 'none'}")
    if not delp_same or written:
        failures.append(f"delp kept {delp_same}, input fields written {written}")
    del el_after, before, sfc_before
    # one gray radiation call on the advanced state (the skin of the
    # surface), its column energy and its OLR
    rcfg = el_ph.radiation_config
    s2 = rad.sin_latitude(el_case.grid.f0) ** 2
    t_surf = el_ph._surface.tskin(sfc)
    t_lay = el_in.pt * el_in.pkz
    pt_r, _ = rad.gray_radiation_step_fluxes(el_in.pt, el_in.pkz, el_in.pe, el_in.ps, s2,
                                             ddemo.TIMESTEP, rcfg, t_surf=t_surf)
    up, down = rad.lw_fluxes(t_lay, rad.optical_depth(el_in.pe, el_in.ps, s2, rcfg), t_surf)
    column_closure("[step earthlike] gray radiation", pt_r.double() * el_in.pkz.double()
                   - t_lay.double(), el_in.pe, down - up, ddemo.TIMESTEP, t_lay,
                   constants.CP_AIR, constants.GRAV)
    olr = ring(up[:, 0], 3)
    log(f"[step earthlike] gray OLR in [{float(olr.min()):.3f}, {float(olr.max()):.3f}] W/m^2 "
        f"(allowed {OLR_RANGE})")
    if not OLR_RANGE[0] <= float(olr.min()) <= float(olr.max()) <= OLR_RANGE[1]:
        failures.append(f"gray OLR range [{float(olr.min())}, {float(olr.max())}]")
    if failures:
        raise AssertionError("[step earthlike] checks failed: " + "; ".join(failures))
    del pt_r, up, down, t_lay, t_surf, s2, diag

    def earthlike_step():
        el_case.state = el_ph(el_case.core.step_dynamics(el_case.state), el_case.time_seconds)
        el_case.time_seconds += el_case.core.timestep

    elstep_dev = profile_steps("dycore step earthlike", earthlike_step, el_out["ms_per_step"],
                               top=15, calls=1)
    el_in, el_stats = el_case.state, {}
    el_dev = profile_steps("earthlike physics call", lambda: el_ph(el_in, el_case.time_seconds),
                           el_out["physics_ms_per_step"], top=20, calls=1, stats=el_stats)
    log(f"[step earthlike] physics call: device time {ms(el_dev)} against "
        f"{el_out['physics_ms_per_step']:.3f} ms of wall time, {el_stats.get('launches')} device "
        f"launches (kernels, copies and sets) a call; the step with the physics: device time "
        f"{ms(elstep_dev)} against {ms(step_dev)} of [step]")

    # three physics calls alone on the advanced state: warm (the surface
    # state is built), then one timed call and one under the profiler
    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    alone = {"band_radiation, land": dict(schemes=("band_radiation",),
                                          surface_config=SurfaceConfig(type="land")),
             "aquaplanet_c24.yaml's set": pdemo.AQUAPLANET,
             "RJ_simple_physics": dict(schemes=("RJ_simple_physics",))}
    failures = []
    for label, kw in alone.items():
        ph = pdemo.make_physics(el_case.grid, **kw)
        ph(el_in, el_case.time_seconds)
        res = {}
        w_ms = wall_ms(lambda: res.update(out=ph(el_in, el_case.time_seconds)))
        stats = {}
        d_ms = profile_steps(f"{label} physics call", lambda: ph(el_in, el_case.time_seconds),
                             w_ms, top=8, calls=1, stats=stats)
        finite = all(bool(torch.isfinite(ring(getattr(res["out"], f), 3)).all())
                     for f in PHYSICS_FIELDS)
        log(f"[physics alone] {label} at C{n} npz={npz} f32: {w_ms:.3f} ms of wall time, device "
            f"time {ms(d_ms)}, {stats.get('launches')} device launches a call; finite {finite}")
        if not finite:
            failures.append(f"{label}: non-finite fields")
        if label.startswith("band"):
            bcfg = ph.band_radiation_config
            qv = el_in.q[:, names.index("qvapor")]
            qc = el_in.q[:, names.index("qliquid")] + el_in.q[:, names.index("qice")]
            t_lay = el_in.pt * el_in.pkz
            t_surf = ph._surface.tskin(ph.surface_state)
            pt_b, _, _ = band.band_radiation_step_fluxes(
                el_in.pt, el_in.pkz, el_in.pe, el_in.ps, ddemo.TIMESTEP, bcfg, qv=qv, qc=qc,
                t_surf=t_surf)
            delp = el_in.pe[:, 1:] - el_in.pe[:, :-1]
            dtau = band.lw_band_optical_depths(qv, qc, 0.5 * (el_in.pe[:, 1:] + el_in.pe[:, :-1]),
                                               delp, bcfg)
            up, down = band.lw_band_fluxes(t_lay, dtau, t_surf)
            sw, _ = band.sw_fluxes(qv, qc, delp, torch.full_like(el_in.ps, bcfg.cos_zenith_mean),
                                   bcfg)
            column_closure(f"[physics alone] {label} LW+SW", pt_b.double() * el_in.pkz.double()
                           - t_lay.double(), el_in.pe, sw + down - up, ddemo.TIMESTEP, t_lay,
                           constants.CP_AIR, constants.GRAV)
            olr = ring(up[:, 0], 3)
            log(f"[physics alone] {label} OLR in [{float(olr.min()):.3f}, {float(olr.max()):.3f}]"
                f" W/m^2 (allowed {OLR_RANGE})")
            if not OLR_RANGE[0] <= float(olr.min()) <= float(olr.max()) <= OLR_RANGE[1]:
                failures.append(f"band OLR range [{float(olr.min())}, {float(olr.max())}]")
            del pt_b, dtau, up, down, sw
        del ph, res
    if failures:
        raise AssertionError("physics calls alone: " + "; ".join(failures))
    log(f"[step earthlike] peak memory of the physics slice "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del el_case, el_in, el_ph, sfc, sfc_in
    torch.cuda.empty_cache()

    log(f"[wall] section 6 (the rest of the physics) took {time.perf_counter() - t_phys:.1f} s")

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
        "pgrad": ("pace_tpu_torch/csrc/pgrad.cu", "pace_tpu/ops/pgrad_pallas.py:198"),
        "remap": ("pace_tpu_torch/csrc/remap.cu", "pace_tpu/ops/remap_pallas.py:33"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        by_path = {"tracer_advection": launches[name], "cgrid_half_step": c_launches[name],
                   "nh_cgrid_half_step": n_launches[name],
                   "acoustic_substep": s_launches[name], "dycore_step": st_launches[name],
                   "dycore_step_hydrostatic": h_launches[name],
                   "dycore_step_consv_te": e_launches[name],
                   "dycore_step_physics": p_launches[name],
                   "dycore_step_sat_adj": sa_launches[name],
                   "dycore_step_earthlike": el_launches[name],
                   "dycore_step_held_suarez": hs_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    log(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
