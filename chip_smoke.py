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
   launches);
7. the driver (``pace_tpu_torch.driver``), after the earlier cases are freed:
   ``[driver baroclinic_c192]``, the slice's main path:
   ``examples/configs/baroclinic_c192.yaml`` read by the port's YAML reader
   and run by ``Driver`` for 20 minutes (6 steps of 200 s, C192 npz=79 f32,
   all fourteen kernels) with ``STABLE_DAMPING`` and the HaloExchange stage
   split out, its outputs under ``chiprun_out/driver/``: the safety checks
   pass, the launches are exactly ``[step]``'s per step (the 6 steps and
   the stage profile's one), the state is bit-identical to 6 direct
   ``step_dynamics`` calls from ``DycoreState.from_analytic_init``, the
   diagnostics hold finite ``ps``, ``ua``, ``va``, ``pt``, ``lat``, ``lon``,
   ``time``, the performance JSON is written; the mainloop's ms/step and
   SYPD beside ``[step]``'s, and the stage device times;
   ``[driver cli earthlike_c24]``: ``python -m pace_tpu_torch.driver.run``
   on ``earthlike_c24.yaml`` in a subprocess (rc 0, 2 finite records of
   ``ps``, ``ua``, ``precipitation`` and ``tskin``, tskin in range, the
   performance JSON); ``[driver f64]``: that yaml cut to C12 npz=8 and 2
   steps in float64 on the card and on the CPU, every state field, the
   surface state and the diagnostics' fields within 1e-12 of each field's
   scale, the stored float32 records within one ulp. The card has no
   ``h5py``: these phases write NetCDF diagnostics and no restart
   (``DIAGNOSTICS_FORMAT``);
8. what ROADMAP queue 1 item 3 added (``item3_phases``):
   ``[driver tropicalcyclone_c128]``, this slice's main path:
   ``examples/configs/tropicalcyclone_c128.yaml`` as written (C128, npz=63,
   f32, stretched 3x toward 180 E 10 N, 24 steps of 150 s, diagnostics every
   6 steps), with the launch counters set to 0 just before its steps: the
   first step's time beside the TC initial state's host time, the
   mainloop's ms/step over steps 2-24 and SYPD, peak memory, each kernel's
   launches per step call, the central pressure and largest wind at each
   output (gates: all 24 steps with the safety checks passing, finite
   fields, ``TC_PS_MIN_RANGE``, ``TC_WIND_MAX``, every kernel launched);
   then one more step of the final state in which every kernel's wrapper
   keeps its operands at its first launch of each form, and each kernel is
   held against its plain version on them by the gates of section 2
   (``check_path_kernels``: C128, npz=63, the stretched metric, the D-grid
   tail at the config's ``nord=2``); ``[driver tc f64]``: that config at
   C12 npz=8, 2 steps in float64, card against CPU within 1e-12 of each
   field's scale; ``[driver external_c12]``: six FRE supergrid tiles and an eta file
   written from the generated C12 grid (``write_fre_supergrid``,
   ``write_eta_file``), its metric terms within rtol 1e-6 of the generated
   ones, the config run for its 4 steps on layout [2, 2]; ``[driver
   fortran_restart]``: a Fortran restart directory of 2 steps of
   ``baroclinic_c12.yaml`` (``write_fortran_restart``, float64) loaded
   through ``baroclinic_c12_read_restart_fortran.yaml`` bit for bit and run
   for 4 steps from ``coupler.res``'s time; ``[savepoint golden]``:
   ``savepoint_cli validate`` of ``pace_tpu``'s committed recordings in
   float64 (1 and 3 steps); ``[driver debug_checks]``: a clean run and a NaN
   caught at ``FVDynamics-In``; ``[driver pair_debug]``: the replica
   bit-identical at every stage, its wall time beside the run without it;
   ``[driver from_savepoint]``: an ``FVDynamics-In`` file of the port's
   ``TranslateFVDynamics`` initializes the config; ``[geos]``: the GEOS
   wrapper at C12, one step, float64, card against CPU within 1e-12;
9. what ROADMAP queue 1 items 7 and 8 added (``comm_mesh_phases``):
   ``[comm]``: the three comm yamls as written (C12, npz=39, hydrostatic,
   ``k_split=1``, ``n_split=2``, 4 steps): the write run records its
   exchanges (halo kernel launched), the read run replays them with no
   halo launch to the write run's final state bit for bit, the null run
   launches no halo kernel and stops at its safety check after step 1 as
   ``pace_tpu``'s does (and runs its 4 steps without the checks), and the
   card's recording holds the tags of a CPU run of the port at the same
   config; ``[mesh 1 rank]``: ``[driver baroclinic_c192]``'s config with
   ``mesh_config.enabled`` on one NCCL rank (the phase fails where this
   PyTorch has no NCCL): the state bit-identical to section 7's run, its
   launches equal, its ms/step beside that run's; ``[mesh 3 ranks]``: the
   config cut to C48 on layout [2, 2], 2 steps, in three processes of this
   script (``--mesh-rank R --mesh-job JOB.json``) sharing the card (gloo,
   the halo frames through host buffers; the kernels built before they
   start), the interior bit-identical to one process, every kernel
   launched on each rank, row 1's launches a step on each rank, the
   processes' wall; and the same ranks at C12 npz=8 in float64 with
   ``consv_te``, 1 step, within 1e-12 of each field's scale of the CPU's
   one process. Section 2 also holds sim1's θ-blend (``a_imp = 0.75``) against
   its plain version by sim1's gate, with its time.

The last lines are the card's name and power limit (``nvidia-smi``), the
``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
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

#: the driver phases' diagnostics store: h5py is not installed on the H100
#: machine (PyYAML and click are; the port needs neither), so they write
#: NetCDF-3 and no restart, whose files are HDF5 as pace_tpu's are
DIAGNOSTICS_FORMAT = "netcdf"
#: [driver baroclinic_c192] runs the yaml for 20 minutes: 6 steps of 200 s,
#: the yaml's output_frequency of 6 gives one diagnostics record
DRIVER_C192_MINUTES = 20


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


def agree(a, b):
    """Pointwise: ``a`` equals ``b``, a NaN agreeing with a NaN (ghost cells
    that no stage fills hold the same NaN on both sides)."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def max_err(a, b):
    """Largest ``|a - b|`` where the two disagree; inf where a value that is
    not finite is on one side only."""
    d = torch.where(agree(a, b), torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


def amax(t):
    """Largest ``|t|`` over the finite values of ``t`` (0 for none)."""
    f = t.abs()
    f = torch.where(torch.isfinite(f), f, torch.zeros_like(f))
    return float(f.max()) if f.numel() else 0.0


def eps(t):
    return torch.finfo(t.dtype).eps


def check_close(label, got, ref, tol_abs):
    """Max abs error of ``got`` against ``ref``; raises beyond ``tol_abs``."""
    err = max_err(got, ref)
    scale = amax(ref)
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
    scale = amax(truth)
    e_plain = max_err(plain.double(), truth)
    e_kernel = max_err(got.double(), truth)
    err = max_err(got, plain)
    if not math.isfinite(e_plain):
        raise AssertionError(f"{label}: the plain version is not finite where its float64 "
                             f"evaluation is")
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
    n_diff = int((~agree(got, ref)).sum())
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
        scale = amax(ring(b, 3))
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


def check_physics_f64(label, card, cpu, setup="C24 npz=8 f64"):
    """Each field of ``card`` (name -> tensor on the card) within
    STEP_F64_REL_TOL of the largest value of ``cpu``'s on the compute
    domain, or raise."""
    worst = {}
    for nm, y in cpu.items():
        x, y = ring(card[nm].cpu(), 3), ring(y, 3)
        worst[nm] = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
    log(f"[check] {setup} {label}, card vs CPU plain path: max diff over each field's "
        "maximum: " + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
    bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
    if bad:
        raise AssertionError(f"{setup} {label} departs from the CPU reference: {bad}")


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
    # their kernels' time too, and the device-side spans of the stage ranges
    # (utils/ranges.py, recorded while the profiler runs) cover kernels
    averages = prof.key_averages()
    ranges = {e.key for e in averages if e.is_user_annotation}
    rows = [(e.key, e.self_device_time_total / (1e3 * calls), e.count // calls)
            for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation and e.key not in ranges]
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


def check_single_field(label, args, kw=None):
    """The single-field transport kernel (``fvtp2d_cuda`` on ``args`` and
    the keywords ``kw``) against its plain version: bit-identical on the
    consumed region, or raise. Returns the max abs error there."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk

    got = fk.fvtp2d_cuda(*args, **(kw or {}))
    ref = fk.fvtp2d_plain(*args, **(kw or {}))
    torch.cuda.synchronize()
    err = 0.0
    for nm, a, b in zip(("fx", "fy"), got, ref):
        a, b = consumed(a), consumed(b)
        e = max_err(a, b)
        n_diff = log_identical(f"fvtp2d {label} {nm} (consumed region; max abs err {e:.3e} of "
                               f"max|flux| {amax(b):.3e})", a, b)
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


# ----------------------------------------------------------------------
# Kernel gates: each calls a kernel's wrapper and its plain version on the
# same operands and holds the two together, or raises. Section 2 runs them
# on its C192 operands, check_path_kernels on the operands a driver step
# gives each kernel.
# ----------------------------------------------------------------------
def check_halo(label, arrays, plan, n_out=None):
    """The exchange kernel on lifted ``arrays`` against its plain version
    (over the first ``n_out`` shards): the same bytes in every output, or
    raise. Returns the max abs error."""
    from pace_tpu_torch.parallel import halo_kernel as hk

    got = hk.halo_cuda(arrays, plan, n_out)
    ref = hk.halo_plain(arrays, plan, n_out)
    torch.cuda.synchronize()
    for name in ref:
        if not same_bits(got[name], ref[name]):
            raise AssertionError(f"halo {label} output {name}: max abs err "
                                 f"{max_err(got[name], ref[name])}")
    log(f"[check] halo {label} {' '.join(str(tuple(v.shape)) for v in arrays.values())}: exact")
    return 0.0


def check_fvtp2d_tracer(label, *args):
    """The tracer-block transport kernel against its plain version:
    bit-identical on the consumed region, or raise. Returns the max abs
    error there."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk

    got = fk.fvtp2d_tracer_cuda(*args)
    ref = fk.fvtp2d_tracer_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for nm, a, b in zip(("fx", "fy"), got, ref):
        a, b = consumed(a), consumed(b)
        e = max_err(a, b)
        n_diff = log_identical(f"fvtp2d tracer {label} {nm} (consumed region; max abs err "
                               f"{e:.3e} of max|flux| {amax(b):.3e})", a, b)
        if n_diff:
            raise AssertionError(f"fvtp2d tracer {label} {nm}: {n_diff} points differ from "
                                 f"the plain version")
        err = max(err, e)
    return err


def check_fvtp2d_multi(label, fields, crx, cry, xfx, yfx, area, mfx=None, mfy=None,
                       names=None):
    """The multi-field transport kernel: each field's fluxes equal to the
    single-field launch's on the whole plane and within 4 ulp of the plain
    version's maximum on the consumed region, or raise. Returns (the
    kernel's outputs, the max abs error of each field)."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk

    got = fk.fvtp2d_multi_cuda(fields, crx, cry, xfx, yfx, area, mfx=mfx, mfy=mfy)
    ref = fk.fvtp2d_multi_plain(fields, crx, cry, xfx, yfx, area, mfx=mfx, mfy=mfy)
    errs = []
    for i, (pair, rpair, (qx, qy, hord, use_mf)) in enumerate(zip(got, ref, fields)):
        fname = names[i] if names else f"field {i} hord {hord}"
        kw = dict(mfx=mfx, mfy=mfy) if use_mf else {}
        single = fk.fvtp2d_cuda(qx, qy, crx, cry, xfx, yfx, area, hord, **kw)
        torch.cuda.synchronize()
        e = 0.0
        for nm, a, b, c in zip(("fx", "fy"), pair, rpair, single):
            if not same_bits(a, c):
                raise AssertionError(f"fvtp2d multi {label} {fname} {nm} differs from the "
                                     f"single-field launch at {int((~agree(a, c)).sum())} points")
            a, b = consumed(a), consumed(b)
            e = max(e, check_close(f"fvtp2d multi {label} {fname} {nm} (consumed region; equal "
                                   f"to the single-field launch everywhere)", a, b,
                                   4 * eps(b) * amax(b)))
            log_identical(f"fvtp2d multi {label} {fname} {nm}", a, b)
        errs.append(e)
    return got, errs


def check_d2a2c(label, u, v, grid):
    """d2a2c against its plain version: ua, va on the whole plane, uc, vc on
    all but the outer two rings (c_sw reads ring 2), ut, vt on all but the
    outer three; there the kernel rounds op for op like the plain version,
    bit for bit, or raise. Returns (the kernel's outputs, max abs error)."""
    from pace_tpu_torch.ops import d2a2c as d2a2c_ops
    from pace_tpu_torch.ops import d2a2c_kernel as d2k

    got = d2k.d2a2c_cuda(u, v, grid)
    ref = d2a2c_ops.d2a2c_plain(u, v, grid)
    torch.cuda.synchronize()
    err = 0.0
    for nm, a, b, r in zip(("ua", "va", "uc", "vc", "ut", "vt"), got, ref, (0, 0, 2, 2, 3, 3)):
        a, b = ring(a, r), ring(b, r)
        err = max(err, check_close(f"d2a2c {label} {nm} (outer {r} rings off)", a, b,
                                   4 * eps(b) * amax(b)))
        if log_identical(f"d2a2c {label} {nm} (outer {r} rings off)", a, b):
            raise AssertionError(f"d2a2c {label} {nm}: differs from the plain version on the "
                                 f"rings a consumer reads")
    return got, err


def check_c_sw_tail(label, *args):
    """The C-grid tail (operands as ``c_sw_tail_cuda`` takes them) within 4
    ulp of each output's maximum on the whole plane and bit-identical away
    from the cube corners (the plain version's three-quadrant mean there is
    a reciprocal multiply on the card), or raise. Returns (the kernel's
    outputs, the max abs error by output)."""
    from pace_tpu_torch.ops import c_sw as c_sw_ops
    from pace_tpu_torch.ops import c_sw_tail_kernel as ck

    got = ck.c_sw_tail_cuda(*args)
    ref = c_sw_ops.c_sw_tail_plain(*args)
    torch.cuda.synchronize()
    grid = args[14]
    errs = {}
    for nm, a, b in zip(("delpc", "ptc", "uc_new", "vc_new", "ut", "vt", "xfx", "yfx",
                         "divg_d"), got, ref):
        errs[nm] = check_close(f"c_sw tail {label} {nm} (whole plane)", a, b,
                               4 * eps(b) * amax(b))
        far = away_from_cube_corners(grid, a.shape, a.device)
        diff = ~agree(a, b)
        n_far, n_near = int(diff[far].sum()), int(diff[~far].sum())
        log(f"[check] c_sw tail {label} {nm}: {n_far} of {int(far.sum())} points differ from "
            f"the plain version away from the cube corners, {n_near} of {int((~far).sum())} at "
            f"them")
        if n_far:
            raise AssertionError(f"c_sw tail {label} {nm}: {n_far} points differ from the plain "
                                 f"version away from the cube corners")
    return got, errs


HYDRO_OUTPUTS = ("pe", "peln", "pk", "pkz", "gz")


def check_hydro(label, delp, pt, phis, ptop, need=("pk", "pkz", "gz")):
    """The hydrostatic chain's outputs in ``need`` against the plain
    version, by the float64 yardstick of ``check_against_f64``, or raise.
    Returns (the kernel's outputs, the max abs error by output)."""
    from pace_tpu_torch.ops import hydro_kernel as hyk
    from pace_tpu_torch.ops import pgrad as pgrad_ops

    got = hyk.hydrostatic_interfaces_cuda(delp, pt, phis, ptop, need=need)
    ref = pgrad_ops.hydrostatic_interfaces(delp, pt, phis, ptop)
    f64 = pgrad_ops.hydrostatic_interfaces(delp.double(), pt.double(), phis.double(), ptop)
    torch.cuda.synchronize()
    pk64, peln64 = ring(f64[2], 3), ring(f64[1], 3)
    amp = amax(torch.maximum(pk64[:, 1:] / (pk64[:, 1:] - pk64[:, :-1]).abs(),
                             1.0 / (peln64[:, 1:] - peln64[:, :-1]).abs()))
    log(f"[check] hydro {label}: K={delp.shape[1]}, need {tuple(need)}, cancellation factor "
        f"max(pk/dpk, 1/dpeln) = {amp:.1f} on the compute domain")
    errs = {nm: check_against_f64(f"hydro {label} {nm}", a, b, c, eps(delp))
            for nm, a, b, c in zip(HYDRO_OUTPUTS, got, ref, f64) if a is not None}
    return got, errs


def check_heights(label, delz, phis):
    """The interface heights by the float64 yardstick, or raise. Returns
    (the kernel's heights, the plain version's, the max abs error)."""
    from pace_tpu_torch.ops import nonhydro as nh_ops
    from pace_tpu_torch.ops import updatedz_kernel as uzk

    got = uzk.heights_from_delz_cuda(delz, phis)
    ref = nh_ops.heights_from_delz_plain(delz, phis)
    f64 = nh_ops.heights_from_delz_plain(delz.double(), phis.double())
    torch.cuda.synchronize()
    err = check_against_f64(f"heights {label} zh", got, ref, f64, eps(delz))
    log_identical(f"heights {label} zh", got, ref)
    return got, ref, err


def check_updatedz_c(label, *args):
    """updatedz_c (one IEEE division a point, op for op like the plain
    version) bit-identical outside the unspecified outermost ring, or raise.
    Returns (the kernel's outputs, the max abs error by output)."""
    from pace_tpu_torch.ops import nonhydro as nh_ops
    from pace_tpu_torch.ops import updatedz_kernel as uzk

    got = uzk.updatedz_c_cuda(*args)
    ref = nh_ops.updatedz_c_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for nm, a, b in zip(("zh", "ws"), got, ref):
        a, b = ring(a, 1), ring(b, 1)
        errs[nm] = check_close(f"updatedz_c {label} {nm} (outer ring off)", a, b,
                               4 * eps(b) * amax(b))
        if log_identical(f"updatedz_c {label} {nm} (outer ring off)", a, b):
            raise AssertionError(f"updatedz_c {label} {nm}: differs from the plain version "
                                 f"outside the outer ring")
    return got, errs


def sim1_plain(w, delz, pt, delp, pkz, ws, dt, ptop=0.0, p_fac=0.0, a_imp=1.0):
    """The plain vertical solve as the kernel computes it: the floor of
    ``p_fac`` applied where ``p_fac > 0``."""
    from pace_tpu_torch.ops import nonhydro as nh_ops

    w_n, dz_n, pp_n = nh_ops.sim1_solver(w, delz, pt, delp, pkz, ws, dt, ptop, a_imp=a_imp)
    if p_fac > 0.0:
        dz_n = nh_ops._p_fac_floor(dz_n, pt, delp, pkz, ptop, p_fac)
    return w_n, dz_n, pp_n


def check_sim1_kernel(label, w, delz, pt, delp, pkz, ws, dt, ptop=0.0, p_fac=0.0, a_imp=1.0):
    """The vertical solve on float32 operands within 4 ulp of each output's
    maximum, and on the same operands in float64 within SIM1_F64_REL_TOL,
    on the columns a consumer reads, or raise. Float32: the difference of
    two pressures near 1e5 Pa leaves the plain version itself further from
    its float64 evaluation than w and pp are large, so that error is no
    yardstick; the kernel keeps the plain version's operation order, and on
    the card torch.log rounds as logf and torch.cumsum sums in sequence: 4
    ulp are the same roundings. Float64: the kernel's formulas, independent
    of how log rounds. Returns (the kernel's outputs, the float32 errors)."""
    from pace_tpu_torch.ops import sim1_kernel as s1k

    args = (w, delz, pt, delp, pkz, ws)
    got = s1k.sim1_solver_cuda(*args, dt, ptop, p_fac=p_fac, a_imp=a_imp)
    ref = sim1_plain(*args, dt, ptop, p_fac, a_imp)
    torch.cuda.synchronize()
    errs = check_sim1(f"sim1 {label} f32", got, ref, dict.fromkeys(("w", "delz", "pp"),
                                                                  4 * eps(w)))
    args64 = [t.double() for t in args]
    got64 = s1k.sim1_solver_cuda(*args64, dt, ptop, p_fac=p_fac, a_imp=a_imp)
    f64 = sim1_plain(*args64, dt, ptop, p_fac, a_imp)
    torch.cuda.synchronize()
    check_sim1(f"sim1 {label} f64", got64, f64, SIM1_F64_REL_TOL)
    for nm, a, b in zip(("w", "delz", "pp"), ref, f64):
        log(f"[check] sim1 {label} {nm}: the plain float32 version is "
            f"{max_err(ring(a, 3).double(), ring(b, 3)):.3e} from its float64 evaluation on "
            f"the compute domain (max {amax(ring(b, 3)):.3e})")
    return got, errs


def check_d_sw_tail(label, *args):
    """The D-grid tail (operands as ``d_sw_tail_cuda`` takes them) within 4
    ulp of each output's maximum on the compute domain and bit-identical
    away from the cube corners (whose energy the plain version divides by
    3.0 as a reciprocal multiply), or raise. Returns (the kernel's outputs,
    the max abs error by output)."""
    from pace_tpu_torch.ops import d_sw as d_sw_ops
    from pace_tpu_torch.ops import d_sw_tail_kernel as dtk

    got = dtk.d_sw_tail_cuda(*args)
    ref = d_sw_ops.d_sw_tail_plain(*args)
    torch.cuda.synchronize()
    grid = args[10]
    errs = {}
    for nm, a, b in zip(("u_new", "v_new", "heat"), got, ref):
        if b is None:
            if a is not None:
                raise AssertionError(f"d_sw tail ({label}): {nm} returned, none expected")
            continue
        errs[nm] = check_close(f"d_sw tail ({label}) {nm} (compute domain)", ring(a, 3),
                               ring(b, 3), 4 * eps(b) * amax(ring(b, 3)))
        log_identical(f"d_sw tail ({label}) {nm}, whole plane", a, b)
        far = away_from_cube_corners(grid, a.shape, a.device)
        n_diff = log_identical(f"d_sw tail ({label}) {nm}, away from the cube corners",
                               a[far], b[far])
        if n_diff:
            raise AssertionError(f"d_sw tail ({label}) {nm}: {n_diff} points away from the "
                                 f"cube corners differ from the plain version")
    return got, errs


def check_flux_height_update(label, *args):
    """The flux-form height update within 4 ulp of its maximum on the
    compute domain, or raise. Returns (the kernel's heights, max abs error)."""
    from pace_tpu_torch.ops import nonhydro as nh_ops
    from pace_tpu_torch.ops import updatedz_kernel as uzk

    got = uzk.flux_height_update_cuda(*args)
    ref = nh_ops.flux_height_update_plain(*args)
    torch.cuda.synchronize()
    err = check_close(f"flux_height_update {label} zh (compute domain)", ring(got, 3),
                      ring(ref, 3), 4 * eps(ref) * amax(ring(ref, 3)))
    log_identical(f"flux_height_update {label} zh, whole plane", got, ref)
    return got, err


def check_nh_p_grad(label, u, v, pk, gz, pp, delp, grid, dt, four_ulp=False):
    """The nonhydrostatic D-grid pressure gradient on the compute domain's u
    and v points (the plain version's pads and rolls leave the outer rings
    unspecified): bit-identical away from the cube corners (whose corner
    value the plain version divides by 3 as a reciprocal multiply), the
    seams between the kernel's interior tiles (no blends) and its edge
    tiles included; everywhere within the float64 yardstick of
    ``check_against_f64`` (the gradient's cancellation amplifies the
    corner's rounding as it amplifies the plain version's own); with
    ``four_ulp``, also within 4 ulp of each output's maximum. Raise
    otherwise. Returns (the kernel's outputs, the max abs error by output)."""
    from pace_tpu_torch.ops import nonhydro as nh_ops
    from pace_tpu_torch.ops import pgrad_kernel as pgk

    args = (u, v, pk, gz, pp, delp, grid, dt)
    got = pgk.nh_p_grad_cuda(*args)
    ref = nh_ops.nh_p_grad(*args)
    f64 = nh_ops.nh_p_grad(*[t.double() for t in args[:6]], grid, dt)
    torch.cuda.synchronize()
    dev = delp.device
    S_, K_, Y_, X_ = delp.shape
    edge = pgk.tile_classes(grid, S_, Y_, X_)
    TY, TX = pgk.TILE
    errs = {}
    for nm, a, b, c in zip(("u", "v"), got, ref, f64):
        near = torch.zeros(a.shape[-2:], dtype=torch.bool, device=dev)
        for _kind, jj, ii, _own in grid.corner_table:
            if nm == "u":
                near[jj, max(ii - 1, 0):ii + 1] = True
            else:
                near[max(jj - 1, 0):jj + 1, ii] = True
        differ = ~agree(a, b)
        far = int(ring(differ & ~near, 3).sum())
        errs[nm] = check_against_f64(f"nh_p_grad {label} {nm} (compute domain)", ring(a, 3),
                                     ring(b, 3), ring(c, 3), eps(b))
        if four_ulp:
            check_close(f"nh_p_grad {label} {nm} (compute domain)", ring(a, 3), ring(b, 3),
                        4 * eps(b) * amax(ring(b, 3)))
        log_identical(f"nh_p_grad {label} {nm}, compute domain", ring(a, 3), ring(b, 3))
        log(f"[check] nh_p_grad {label} {nm}: {far} differing points away from the cube "
            f"corners")
        if far:
            raise AssertionError(f"nh_p_grad {label} {nm}: {far} points differ away from the "
                                 f"cube corners")
        Yo, Xo = a.shape[-2:]
        cls = edge[:, torch.arange(Yo, device=dev) // TY][:, :, torch.arange(Xo, device=dev) // TX]
        seam = torch.zeros_like(cls)
        seam[:, 1:] |= cls[:, 1:] != cls[:, :-1]
        seam[:, :-1] |= cls[:, :-1] != cls[:, 1:]
        seam[:, :, 1:] |= cls[:, :, 1:] != cls[:, :, :-1]
        seam[:, :, :-1] |= cls[:, :, :-1] != cls[:, :, 1:]
        seam = ring(seam & ~near, 3)[:, None]
        n_seam = int(seam.sum()) * K_
        bad = int((ring(differ, 3) & seam).sum())
        log(f"[check] nh_p_grad {label} {nm}: {int((~edge).sum())} interior and "
            f"{int(edge.sum())} edge tiles of {TY}x{TX}; {bad} of {n_seam} points on the seams "
            "between the two classes differ from the plain version")
        if bad or (not n_seam and bool(edge.any()) and bool((~edge).any())):
            raise AssertionError(f"nh_p_grad {label} {nm}: {bad} seam points differ ({n_seam} "
                                 "seam points)")
    return got, errs


def column_change(out, q_in, p1, p2):
    """Largest relative change of a column's integral sum(q dp) (a column
    of zeros must stay zero)."""
    dp1, dp2 = (p[..., 1:, :, :] - p[..., :-1, :, :] for p in (p1, p2))
    before = (q_in.double() * dp1.double()).sum(dim=-3)
    after = (out.double() * dp2.double()).sum(dim=-3)
    scale = (q_in.double().abs() * dp1.double()).sum(dim=-3)
    return float(((after - before).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max())


def check_remap(label, q_in, p1, p2, kord, region):
    """The remap bit-identical to the plain version on ``region`` of the
    output, with each column's integral conserved within 4 K ulp, or
    raise. Returns the max abs error."""
    from pace_tpu_torch.ops import remap_kernel as rmk
    from pace_tpu_torch.ops import remapping as rm_ops

    got = rmk.remap_cuda(q_in, p1, p2, kord)
    ref = rm_ops.remap_field(q_in, p1, p2, kord)
    torch.cuda.synchronize()
    a, b = region(got), region(ref)
    err = check_close(f"remap {label} kord {kord}", a, b, 4 * eps(a) * amax(b))
    if log_identical(f"remap {label} kord {kord}", a, b):
        raise AssertionError(f"remap {label} kord {kord}: not bit-identical to the plain "
                             "version")
    K = q_in.shape[-3]
    ch, ch_ref = (column_change(region(o), region(q_in), region(p1), region(p2))
                  for o in (got, ref))
    tol = 4 * K * eps(a)
    log(f"[check] remap {label} kord {kord}: column integral changes by {ch:.3e} of its "
        f"size at most (plain version {ch_ref:.3e}; tolerance {tol:.3e})")
    if not ch <= tol:
        raise AssertionError(f"remap {label} kord {kord}: column integral changes by {ch}")
    return err


#: each kernel of a dycore step: its wrapper's module and name, the modules
#: that import the wrapper by name, and its gate on the wrapper's operands
PATH_KERNELS = {
    "halo": ("pace_tpu_torch.parallel.halo_kernel", "halo_cuda", (), check_halo),
    "fvtp2d": ("pace_tpu_torch.ops.fvtp2d_kernel", "fvtp2d_cuda", (),
               lambda label, *a, **k: check_single_field(label, a, k)),
    "fvtp2d_tracer": ("pace_tpu_torch.ops.fvtp2d_kernel", "fvtp2d_tracer_cuda", (),
                      check_fvtp2d_tracer),
    "d2a2c": ("pace_tpu_torch.ops.d2a2c_kernel", "d2a2c_cuda", (), check_d2a2c),
    "c_sw_tail": ("pace_tpu_torch.ops.c_sw_tail_kernel", "c_sw_tail_cuda", (), check_c_sw_tail),
    "hydro": ("pace_tpu_torch.ops.hydro_kernel", "hydrostatic_interfaces_cuda", (),
              check_hydro),
    "heights": ("pace_tpu_torch.ops.updatedz_kernel", "heights_from_delz_cuda",
                ("pace_tpu_torch.ops.nonhydro",), check_heights),
    "updatedz_c": ("pace_tpu_torch.ops.updatedz_kernel", "updatedz_c_cuda",
                   ("pace_tpu_torch.ops.nonhydro",), check_updatedz_c),
    "sim1": ("pace_tpu_torch.ops.sim1_kernel", "sim1_solver_cuda",
             ("pace_tpu_torch.ops.nonhydro",), check_sim1_kernel),
    "fvtp2d_multi": ("pace_tpu_torch.ops.fvtp2d_kernel", "fvtp2d_multi_cuda", (),
                     check_fvtp2d_multi),
    "d_sw_tail": ("pace_tpu_torch.ops.d_sw_tail_kernel", "d_sw_tail_cuda", (),
                  lambda label, *a: check_d_sw_tail(f"{label} nord {a[12].nord}", *a)),
    "flux_height_update": ("pace_tpu_torch.ops.updatedz_kernel", "flux_height_update_cuda",
                           ("pace_tpu_torch.ops.nonhydro",), check_flux_height_update),
    "pgrad": ("pace_tpu_torch.ops.pgrad_kernel", "nh_p_grad_cuda",
              ("pace_tpu_torch.ops.nonhydro",), check_nh_p_grad),
    "remap": ("pace_tpu_torch.ops.remap_kernel", "remap_cuda", ("pace_tpu_torch.ops.remapping",),
              lambda label, q, pe1, pe2, kord: check_remap(label, q, pe1, pe2, kord,
                                                           lambda t: ring(t, 3))),
}


def _form(x):
    """What tells two launches of a kernel apart: operand shapes and dtypes,
    options, and the identity of any other object (a grid, a plan)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_form(e) for e in x)
    if isinstance(x, dict):
        return tuple((k, _form(v)) for k, v in sorted(x.items()))
    return ("object", id(x))


def _copy(x):
    """``x`` with every tensor in it cloned (tuples keep their type)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_copy(e) for e in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [_copy(e) for e in x]
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


def path_operands(step_fn):
    """Run ``step_fn`` once with the wrapper of every kernel of
    PATH_KERNELS keeping a copy of its operands at its first launch of each
    form. Returns ``{kernel: [(args, kwargs), ...]}``."""
    import importlib

    seen = {k: {} for k in PATH_KERNELS}
    restore = []

    def keeping(kernel, fn):
        def wrapper(*args, **kwargs):
            key = _form((args, kwargs))
            if key not in seen[kernel]:
                seen[kernel][key] = (_copy(args), _copy(kwargs))
            return fn(*args, **kwargs)
        return wrapper

    try:
        for kernel, (home, name, importers, _gate) in PATH_KERNELS.items():
            wrapper = keeping(kernel, getattr(importlib.import_module(home), name))
            for mod in (importlib.import_module(m) for m in (home,) + importers):
                restore.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrapper)
        step_fn()
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in reversed(restore):
            setattr(mod, name, fn)
    return {k: list(v.values()) for k, v in seen.items()}


def check_path_kernels(label, step_fn):
    """Every kernel of PATH_KERNELS against its plain version, by its gate,
    on the operands of each form that one call of ``step_fn`` gives it; raise
    if a kernel was not launched or a gate fails. Returns the number of
    forms held by kernel."""
    operands = path_operands(step_fn)
    forms = {k: len(calls) for k, calls in operands.items()}
    missing = [k for k, n in forms.items() if not n]
    if missing:
        raise AssertionError(f"{label}: kernels not launched by the step: {missing}")
    for kernel, calls in operands.items():
        gate = PATH_KERNELS[kernel][3]
        while calls:  # each form's copies freed once held
            args, kwargs = calls.pop(0)
            gate(f"{label} form {forms[kernel] - len(calls)}/{forms[kernel]}", *args, **kwargs)
    return forms



# ----------------------------------------------------------------------
# Fixture writers for the input formats the driver reads but never writes:
# FRE-NCtools supergrid tiles with an eta file, and Fortran FV3GFS restart
# directories. They do nothing at import; tests/test_torch_*.py import them.
# ----------------------------------------------------------------------
#: the coupler.res times the restart writer stamps: 30 minutes into the run
COUPLER_START = (2016, 8, 1, 0, 0, 0)
COUPLER_CURRENT = (2016, 8, 1, 0, 30, 0)


def write_fre_supergrid(pattern, n):
    """Six FRE-NCtools supergrid tile files ``pattern.format(tile=t)``
    (t = 1..6) of the port's gnomonic C``n`` cube: variables ``x``
    (longitude) and ``y`` (latitude) in degrees on the (2n+1, 2n+1) points
    of the half-cell supergrid. Returns ``pattern``."""
    from pace_tpu_torch.grid.gnomonic import chart_to_sphere
    from pace_tpu_torch.utils import netcdf3

    coords = np.arange(2 * n + 1) / 2.0  # chart cell units 0..n in steps of 0.5
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    for t in range(6):
        xyz = chart_to_sphere(t, gy, gx, n)
        lon = np.rad2deg(np.arctan2(xyz[..., 1], xyz[..., 0])) % 360.0
        lat = np.rad2deg(np.arcsin(np.clip(xyz[..., 2], -1, 1)))
        netcdf3.write(pattern.format(tile=t + 1), netcdf3.NetCDF3File(
            dims={"nyp": 2 * n + 1, "nxp": 2 * n + 1},
            variables={
                "x": netcdf3.Variable(("nyp", "nxp"), lon, {"units": "degree_east"}),
                "y": netcdf3.Variable(("nyp", "nxp"), lat, {"units": "degree_north"}),
            },
            attrs={}))
    return pattern


def write_eta_file(path, ak, bk):
    """A NetCDF-3 file with the hybrid coefficients ``ak`` [Pa] and ``bk``
    on the npz+1 interfaces, as ``eta_file`` reads them."""
    from pace_tpu_torch.utils import netcdf3

    ak, bk = np.asarray(ak, np.float64), np.asarray(bk, np.float64)
    netcdf3.write(path, netcdf3.NetCDF3File(
        dims={"km": ak.size},
        variables={"ak": netcdf3.Variable(("km",), ak, {"units": "Pa"}),
                   "bk": netcdf3.Variable(("km",), bk, {"units": ""})},
        attrs={}))


def _tiles(shards, mt, y_stag=0, x_stag=0):
    """The six tiles (6, ..., ny + y_stag, nx + x_stag) of a stacked-shard
    array (S, ..., Y, X): each shard's compute domain (with its interface
    row or column) at its place in its tile."""
    halo = mt.halo
    h, nsy, nsx = halo.n_halo, halo.nsy, halo.nsx
    n = mt.spec.n_tile
    out = np.zeros((6,) + shards.shape[1:-2] + (n + y_stag, n + x_stag), shards.dtype)
    for s in range(halo.n_shards):
        t, py, px = halo._shard_info(s)
        out[t, ..., py * nsy:(py + 1) * nsy + y_stag, px * nsx:(px + 1) * nsx + x_stag] = \
            shards[s, ..., h:h + nsy + y_stag, h:h + nsx + x_stag]
    return out


def write_fortran_restart(path, state, mt, start=COUPLER_START, current=COUPLER_CURRENT):
    """A Fortran FV3GFS restart directory of ``state`` (a port
    ``DycoreState`` on the grid of ``mt``): ``fv_core.res.nc`` with ``ak``
    and ``bk``; per tile ``fv_core.res.tile{t}.nc`` (``u``, ``v``, ``W``,
    ``DZ``, ``T``, ``delp``, ``phis``), ``fv_tracer.res.tile{t}.nc`` (the
    nine tracers under their Fortran names) and ``fv_srf_wnd.res.tile{t}.nc``
    (``u_srf``, ``v_srf``: the lowest layer's A-grid winds); and
    ``coupler.res`` with ``start`` and ``current`` as its model times. Each
    variable carries a leading ``Time`` axis of length 1, as the model's
    files do. ``T`` is the temperature of the state's virtual potential
    temperature and layer-mean Exner function. Returns the host arrays
    written, per tile, keyed by their Fortran names."""
    from pace_tpu_torch import constants
    from pace_tpu_torch.driver.fortran_restart import FORTRAN_TRACER_NAMES
    from pace_tpu_torch.utils import netcdf3

    os.makedirs(path, exist_ok=True)
    host = {k: np.asarray(v, np.float64) for k, v in state.to_numpy().items()}
    npz = mt.spec.npz
    netcdf3.write(os.path.join(path, "fv_core.res.nc"), netcdf3.NetCDF3File(
        dims={"xaxis_1": npz + 1, "Time": 1},
        variables={"ak": netcdf3.Variable(("Time", "xaxis_1"), mt.ak[None], {"units": "Pa"}),
                   "bk": netcdf3.Variable(("Time", "xaxis_1"), mt.bk[None], {"units": ""})},
        attrs={}))
    qv = host["q"][:, constants.TRACER_NAMES.index("qvapor")]
    temp = host["pt"] * host["pkz"] / (1.0 + constants.ZVIR * qv)
    core = {"u": _tiles(host["u"], mt, y_stag=1), "v": _tiles(host["v"], mt, x_stag=1),
            "W": _tiles(host["w"], mt), "DZ": _tiles(host["delz"], mt), "T": _tiles(temp, mt),
            "delp": _tiles(host["delp"], mt), "phis": _tiles(host["phis"], mt)}
    tracers = {f: _tiles(host["q"][:, constants.TRACER_NAMES.index(ours)], mt)
               for f, ours in FORTRAN_TRACER_NAMES.items()}
    wind = {"u_srf": _tiles(host["ua"][:, -1], mt), "v_srf": _tiles(host["va"][:, -1], mt)}
    n = mt.spec.n_tile
    dims = {"xaxis_1": n, "xaxis_2": n + 1, "yaxis_1": n + 1, "yaxis_2": n, "zaxis_1": npz,
            "Time": 1}
    axes = {"u": ("yaxis_1", "xaxis_1"), "v": ("yaxis_2", "xaxis_2")}
    for t in range(6):
        for stem, fields in (("fv_core.res", core), ("fv_tracer.res", tracers),
                             ("fv_srf_wnd.res", wind)):
            variables = {"Time": netcdf3.Variable(("Time",), np.array([1.0]),
                                                  {"units": "time level"})}
            for name, arr in fields.items():
                a = arr[t][None]
                hor = axes.get(name, ("yaxis_2", "xaxis_1"))
                variables[name] = netcdf3.Variable(
                    ("Time",) + (("zaxis_1",) if a.ndim == 4 else ()) + hor, a)
            netcdf3.write(os.path.join(path, f"{stem}.tile{t + 1}.nc"),
                          netcdf3.NetCDF3File(dims=dict(dims), variables=variables, attrs={}))
    with open(os.path.join(path, "coupler.res"), "w") as f:
        f.write("     2        (Calendar: no_calendar=0, thirty_day_months=1, julian=2, "
                "gregorian=3, noleap=4)\n")
        for when, label in ((start, "Model start time:   "), (current, "Current model time: ")):
            f.write("".join(f"{v:6d}" for v in when)
                    + f"        {label}year, month, day, hour, minute, second\n")
    return {**core, **tracers, **wind}


#: the GEOS wrapper's namelist in [geos] (tests/main/test_geos_wrapper.py's)
GEOS_NML = """
&fv_core_nml
    npx = 13
    npy = 13
    npz = 6
    k_split = 1
    n_split = 2
    hydrostatic = .false.
    nord = 1
    d4_bg = 0.12
    dddmp = 0.2
    do_vort_damp = .true.
    vtdm4 = 0.06
    fill = .T.
    tau = 10.0
    rf_cutoff = 3.0d3
    hord_mt = 6
/
"""
#: [driver tropicalcyclone_c128]'s bounds at each output: the vortex's
#: central pressure [hPa] and the largest wind speed [m/s]
TC_PS_MIN_RANGE = (900.0, 1015.0)
TC_WIND_MAX = 150.0


def hold_f64(label, card, cpu, scales, setup="C12 f64"):
    """Each of STEP_FIELDS of the card's state within STEP_F64_REL_TOL of
    its scale of the CPU's on the compute domain, or raise."""
    worst = {}
    for nm in STEP_FIELDS:
        x, y = getattr(card, nm), getattr(cpu, nm)
        if y is None:
            if x is not None:
                raise AssertionError(f"{label}: {nm} is None on the CPU only")
            continue
        x, y = ring(x.cpu(), 3), ring(y, 3)
        scale = max(float(y.abs().max()), scales.get(nm, 0.0), 1e-300)
        worst[nm] = float((x - y).abs().max()) / scale
    log(f"[check] {setup} {label}, card vs CPU, max diff over each field's scale: "
        + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
    bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
    if bad:
        raise AssertionError(f"{setup} {label} departs from the CPU: {bad}")


def item3_phases(dev, counters, zero_counters, out_root, configs, tc_n=None, tc_npz=None):
    """Section 8: what ROADMAP queue 1 item 3 added to the port, through the
    user's entry points. Returns the launches of every kernel in
    ``[driver tropicalcyclone_c128]``, the slice's main path. ``tc_n`` and
    ``tc_npz`` cut that run for a rehearsal on the CPU; the card runs the
    config as written."""
    from pace_tpu_torch import constants
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
    from pace_tpu_torch.models.fv3.geos_wrapper import GeosDycoreWrapper
    from pace_tpu_torch.models.fv3.state import DycoreState
    from pace_tpu_torch.testing import SanitizerError
    from pace_tpu_torch.testing import savepoint_cli
    from pace_tpu_torch.testing.translate import TranslateFVDynamics
    from pace_tpu_torch.utils import netcdf3, yaml_subset
    from pace_tpu_torch.utils.namelist import Namelist

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def read_yaml(name):
        with open(os.path.join(configs, name)) as f:
            return yaml_subset.safe_load(f)

    def outputs(raw, tag):
        d = os.path.join(out_root, tag)
        dcfg = raw.setdefault("diagnostics_config", {})
        dcfg.update(path=os.path.join(d, dcfg.get("path", "output")),
                    output_format=DIAGNOSTICS_FORMAT)
        pcfg = raw.setdefault("performance_config", {})
        pcfg["experiment_name"] = os.path.join(d, pcfg.get("experiment_name", "exp"))
        return raw

    def finite(state, names=("u", "v", "w", "delz", "delp", "pt", "q", "ps")):
        return [nm for nm in names if getattr(state, nm) is not None
                and not bool(torch.isfinite(ring(getattr(state, nm), 3)).all())]

    t_sec = time.perf_counter()

    # --- [driver tropicalcyclone_c128]: the config as written (24 steps,
    #     diagnostics every 6 steps), its outputs under out_root
    raw = outputs(read_yaml("tropicalcyclone_c128.yaml"), "tropicalcyclone_c128")
    if tc_n is not None:
        raw.update(nx_tile=tc_n, nz=tc_npz)
    cfg = DriverConfig.from_dict(raw)
    init_s = []
    get_state = cfg.initialization.get_dycore_state

    def timed_state(*a, **k):
        t0 = time.perf_counter()
        st = get_state(*a, **k)
        init_s.append(time.perf_counter() - t0)
        return st

    cfg.initialization.get_dycore_state = timed_state
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    drv = Driver(cfg, device=dev)
    build_s = time.perf_counter() - t0
    zero_counters()
    drv.step_all()
    drv.cleanup()
    tc_launches = {k: c[k] for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else float("nan")
    report = drv.performance.report(cfg.dt_atmos)
    step_ms = [1e3 * t for t in drv.performance.step_seconds]
    n_calls = drv._step_count
    dyc = cfg.dycore_config
    log(f"[driver tropicalcyclone_c128] C{cfg.nx_tile} npz={cfg.nz} f32, stretch "
        f"{cfg.grid_config.config.stretch_factor} at ({cfg.grid_config.config.lon_target}, "
        f"{cfg.grid_config.config.lat_target}), k_split={dyc.k_split} n_split={dyc.n_split} "
        f"nord={dyc.nord}, {n_calls} steps of {cfg.dt_atmos:.0f} s: first step "
        f"{step_ms[0]:.3f} ms (kernel builds and allocator warm-up inside it), after the "
        f"Driver's construction of {build_s:.3f} s of which the TC initial state's host time "
        f"{init_s[0]:.3f} s; mainloop {1e3 * report['mainloop_mean_seconds']:.3f} ms/step over "
        f"steps 2-{n_calls}, SYPD {report['SYPD']:.5f}; peak memory {peak:.2f} GB")
    log(f"[driver tropicalcyclone_c128] step ms: {', '.join(f'{t:.3f}' for t in step_ms)}")
    log("[driver tropicalcyclone_c128] launches per step call: "
        + ", ".join(f"{k} {v / max(n_calls, 1):g}" for k, v in tc_launches.items()))
    recs = {nm: v.data for nm, v in netcdf3.read(os.path.join(
        cfg.diagnostics_config.path, "diagnostics.nc")).variables.items()}
    failures = []
    per_out = []
    for i in range(int(recs["ps"].shape[0])):
        ps_min = float(np.min(recs["ps"][i])) / 100.0
        wind = float(np.sqrt(recs["ua"][i].astype(np.float64) ** 2
                             + recs["va"][i].astype(np.float64) ** 2).max())
        per_out.append((float(recs["time"][i]), ps_min, wind))
        if not (TC_PS_MIN_RANGE[0] <= ps_min <= TC_PS_MIN_RANGE[1] and wind <= TC_WIND_MAX):
            failures.append(f"output {i}: ps min {ps_min} hPa, wind max {wind} m/s")
    log("[driver tropicalcyclone_c128] at each output (time s, ps min hPa, max wind m/s): "
        + "; ".join(f"{t:.0f} s: {p:.3f} hPa, {w:.3f} m/s" for t, p, w in per_out))
    if n_calls != cfg.n_timesteps:
        failures.append(f"{n_calls} steps of {cfg.n_timesteps}")
    if len(per_out) != cfg.n_timesteps // cfg.diagnostics_config.output_frequency:
        failures.append(f"{len(per_out)} diagnostics records")
    failures += [f"{nm} not finite" for nm in finite(drv.state)]
    failures += [f"kernel {k} not on the path" for k, v in tc_launches.items() if v <= 0]
    if failures:
        raise AssertionError("[driver tropicalcyclone_c128] checks failed: "
                             + "; ".join(failures))
    if on_card:
        # where the time goes: two more steps of the final state, profiled
        profile_steps("driver tropicalcyclone_c128 step", lambda: drv.dycore.step_dynamics(
            drv.state), 1e3 * report["mainloop_mean_seconds"], top=12)
        # every kernel against its plain version on the operands one more
        # step of the final state gives it
        t0 = time.perf_counter()
        forms = check_path_kernels(f"TC C{cfg.nx_tile} npz={cfg.nz}",
                                   lambda: drv.dycore.step_dynamics(drv.state))
        log(f"[check] driver tropicalcyclone_c128: every kernel held against its plain version "
            f"on the operands of one step of the final state (forms by kernel: "
            + ", ".join(f"{k} {v}" for k, v in forms.items())
            + f") in {time.perf_counter() - t0:.1f} s")
    # the records (about 200 MB at C128 npz=63) are not kept
    shutil.rmtree(cfg.diagnostics_config.path)
    del drv, recs
    if on_card:
        torch.cuda.empty_cache()

    # --- [driver tc f64]: the TC config's dycore at C12, npz=8, stretch 3.0,
    #     float64, 2 steps, card against CPU
    raw = read_yaml("tropicalcyclone_c128.yaml")
    raw.update(nx_tile=12, nz=8, precision=64, minutes=5)
    runs = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        r = outputs(json.loads(json.dumps(raw)), f"tc_f64_{tag}")
        drv = Driver(DriverConfig.from_dict(r), device=d)
        start = drv.state
        drv.step_all()
        drv.cleanup()
        runs[tag] = (drv, start)
    cpu, start = runs["cpu"]
    hold_f64("driver, tropicalcyclone_c128.yaml's config, 2 steps", runs["card"][0].state,
             cpu.state, step_f64_scales(SimpleNamespace(state=start, grid=cpu.grid_data,
                                                        core=cpu.dycore), constants),
             setup="C12 npz=8 f64 stretch 3.0")
    del runs, cpu, start

    # --- [driver external_c12]: six FRE tiles and eta79.nc from the port's
    #     generated C12 grid, the metric terms against the generated ones,
    #     then the config (layout [2, 2], 4 steps)
    ext_dir = os.path.join(out_root, "external_c12")
    os.makedirs(os.path.join(ext_dir, "C12_grid"), exist_ok=True)
    raw = outputs(read_yaml("external_c12.yaml"), "external_c12")
    tiles = write_fre_supergrid(os.path.join(ext_dir, "C12_grid", "C12.tile{tile}.nc"), 12)
    spec = GridSpec(n_tile=12, npz=raw["nz"], layout=tuple(raw["layout"]))
    gen = MetricTerms.generate(spec)
    write_eta_file(os.path.join(ext_dir, "eta79.nc"), gen.ak, gen.bk)
    ext = MetricTerms.from_external(tiles, spec, eta_file=os.path.join(ext_dir, "eta79.nc"))
    rel = {nm: float(np.max(np.abs(getattr(ext, nm) - getattr(gen, nm))
                            / np.maximum(np.abs(getattr(gen, nm)), 1e-300)))
           for nm in ("area", "dx", "dy", "dxc", "dyc", "lat_agrid", "lon_agrid")}
    bad = [nm for nm in rel if not np.allclose(getattr(ext, nm), getattr(gen, nm),
                                               rtol=1e-6, atol=1e-6)]
    bad += [nm for nm in ("ak", "bk") if not np.array_equal(getattr(ext, nm), getattr(gen, nm))]
    raw["grid_config"]["config"].update(tile_paths=tiles,
                                        eta_file=os.path.join(ext_dir, "eta79.nc"))
    drv = Driver(DriverConfig.from_dict(raw), device=dev)
    t0 = time.perf_counter()
    drv.step_all()
    drv.cleanup()
    sync()
    ext_s = time.perf_counter() - t0
    log(f"[driver external_c12] external metric terms against the generated C12 grid, largest "
        f"relative difference: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f"; ak, bk equal; the config (layout {raw['layout']}, npz={raw['nz']} f32) ran "
        f"{drv._step_count} steps in {ext_s:.3f} s, safety checks passed, ps in "
        f"[{float(ring(drv.state.ps, 3).min()):.3f}, {float(ring(drv.state.ps, 3).max()):.3f}] Pa")
    bad += finite(drv.state)
    if bad or drv._step_count != 4:
        raise AssertionError(f"[driver external_c12] checks failed: {bad}, "
                             f"{drv._step_count} steps")
    del drv, gen, ext

    # --- [driver fortran_restart]: a Fortran restart directory of the state
    #     after 2 steps of baroclinic_c12.yaml (at the restart config's npz,
    #     float64), loaded through baroclinic_c12_read_restart_fortran.yaml
    #     and run for its 4 steps from coupler.res's time
    rraw = read_yaml("baroclinic_c12_read_restart_fortran.yaml")
    raw = outputs(read_yaml("baroclinic_c12.yaml"), "fortran_restart_source")
    raw.update(nz=rraw["nz"], precision=64, minutes=0, seconds=2 * int(raw["dt_atmos"]))
    src = Driver(DriverConfig.from_dict(raw), device=dev)
    src.step_all()
    src.cleanup()
    rdir = os.path.join(out_root, "fortran_restart", "restart_data")
    write_fortran_restart(rdir, src.state, src.metric_terms)
    rraw = outputs(rraw, "fortran_restart")
    rraw.update(precision=64)
    rraw["initialization"]["config"]["path"] = rdir
    drv = Driver(DriverConfig.from_dict(rraw), device=dev)
    differ = [nm for nm in ("u", "v", "w", "delz", "delp", "phis", "q")
              if not same_bits(ring(getattr(drv.state, nm), 3).cpu(),
                               ring(getattr(src.state, nm), 3).cpu())]
    t_start = drv.time_seconds
    drv.step_all()
    drv.cleanup()
    log(f"[driver fortran_restart] {rdir} from 2 steps of baroclinic_c12.yaml (npz="
        f"{rraw['nz']} f64): loaded through baroclinic_c12_read_restart_fortran.yaml, "
        f"{7 - len(differ)} of 7 prognostics (u, v, w, delz, delp, phis, q) bit-identical to "
        f"the written state on the compute domain; clock from coupler.res {t_start:.0f} s, "
        f"{drv._step_count} steps to {drv.time_seconds:.0f} s, safety checks passed")
    bad = differ + finite(drv.state)
    if bad or t_start != 1800.0 or drv._step_count != 4:
        raise AssertionError(f"[driver fortran_restart] checks failed: {bad}, start {t_start}, "
                             f"{drv._step_count} steps")
    del src, drv

    # --- [savepoint golden]: pace_tpu's committed recordings validate the
    #     port on the card in float64
    data = os.path.join(HERE, "tests", "data", "savepoints")
    for cfg_name, ref, th, n_steps in (
            ("baroclinic_c12.yaml", "ref_c12.npz", "thresholds_c12.yaml", 1),
            ("baroclinic_c12_nh.yaml", "ref_c12_nh.npz", "thresholds_c12_nh.yaml", 3)):
        t0 = time.perf_counter()
        rc = savepoint_cli.main(["validate", os.path.join(data, cfg_name), "-r",
                                 os.path.join(data, ref), "-t", os.path.join(data, th),
                                 "--steps", str(n_steps), "--device", dev.type])
        log(f"[savepoint golden] savepoint_cli validate {cfg_name} --steps {n_steps} "
            f"--device {dev.type}: rc {rc} in {time.perf_counter() - t0:.1f} s")
        if rc != 0:
            raise AssertionError(f"[savepoint golden] {cfg_name} failed validation")

    # --- [driver debug_checks]: baroclinic_c12.yaml with the sanitizer;
    #     a NaN in delp raises at the first stage
    raw = outputs(read_yaml("baroclinic_c12.yaml"), "debug_checks")
    raw["debug_checks"] = True
    drv = Driver(DriverConfig.from_dict(raw), device=dev)
    drv.step_all()
    drv.cleanup()
    hits = drv.dycore.checkpointer._hit
    drv = Driver(DriverConfig.from_dict(raw), device=dev)
    delp = drv.state.delp.clone()
    delp[0, 3, 8, 8] = float("nan")
    drv.state = dataclasses.replace(drv.state, delp=delp)
    try:
        drv.step_all()
        raise AssertionError("[driver debug_checks] a NaN in delp was not caught")
    except SanitizerError as e:
        caught = str(e)
    log(f"[driver debug_checks] baroclinic_c12.yaml: a clean run of {drv.config.n_timesteps} "
        f"steps passed {hits} stage checks; a NaN seeded in delp raised SanitizerError: "
        f"{caught}")
    if not caught.startswith("FVDynamics-In.delp"):
        raise AssertionError(f"[driver debug_checks] caught at the wrong stage: {caught}")
    drv.diagnostics.cleanup()
    del drv

    # --- [driver pair_debug]: the replica bit-identical at every stage of
    #     every step, and the wall time beside the same run without it
    walls = {}
    for flag in (True, False):
        raw = outputs(read_yaml("baroclinic_c12.yaml"), f"pair_debug_{flag}")
        raw["pair_debug"] = flag
        drv = Driver(DriverConfig.from_dict(raw), device=dev)
        t0 = time.perf_counter()
        drv.step_all()
        sync()
        walls[flag] = time.perf_counter() - t0
        drv.cleanup()
        if flag:
            stages = sum(drv._pair_cmp._idx.values())
            same = all(torch.equal(getattr(drv.state, f.name), getattr(drv.state_pair, f.name))
                       for f in dataclasses.fields(drv.state)
                       if getattr(drv.state, f.name) is not None)
    log(f"[driver pair_debug] baroclinic_c12.yaml, {drv._step_count} steps: the replica "
        f"bit-identical at all {stages} stage records of each step ({stages * drv._step_count} "
        f"in all), the whole states equal: {same}; wall {walls[True]:.3f} s against "
        f"{walls[False]:.3f} s without pair_debug")
    if not same:
        raise AssertionError("[driver pair_debug] the replica's state differs")
    del drv

    # --- [driver from_savepoint]: an FVDynamics-In file of a C12 state,
    #     written with the port's TranslateFVDynamics, initializes the config
    raw = outputs(read_yaml("baroclinic_c12_from_savepoint.yaml"), "from_savepoint")
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=raw["nz"], layout=tuple(raw["layout"])))
    source = DycoreState.from_analytic_init(mt, device=dev, dtype=torch.float32)
    slabs = TranslateFVDynamics(mt, device=dev).outputs_from_state(source)
    for nm in ("cxd", "cyd"):  # their staggering is unknown to the framework
        slabs.pop(nm)
    sp_path = os.path.join(out_root, "from_savepoint", "FVDynamics-In.nc")
    os.makedirs(os.path.dirname(sp_path), exist_ok=True)
    netcdf3.write_simple(sp_path, slabs)
    # the slabs hold the compute domain alone
    raw["initialization"]["config"].update(path=sp_path, data_halo=0)
    drv = Driver(DriverConfig.from_dict(raw), device=dev)
    differ = [nm for nm in ("u", "v", "delp", "pt", "q", "ps", "phis")
              if not same_bits(ring(getattr(drv.state, nm), 3), ring(getattr(source, nm), 3))]
    drv.step_all()
    drv.cleanup()
    log(f"[driver from_savepoint] {sp_path} ({len(slabs)} variables) through "
        f"baroclinic_c12_from_savepoint.yaml: {7 - len(differ)} of 7 fields (u, v, delp, pt, "
        f"q, ps, phis) of the initial state equal the source state on the compute domain; "
        f"{drv._step_count} steps ran, safety checks passed")
    bad = differ + finite(drv.state)
    if bad:
        raise AssertionError(f"[driver from_savepoint] checks failed: {bad}")
    del drv, source

    # --- [geos]: the GEOS wrapper at C12, one step, float64, card vs CPU
    outs = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        w = GeosDycoreWrapper(Namelist.from_f90nml(GEOS_NML), n_tile=12, npz=6, bdt=300.0,
                              device=d, dtype=torch.float64)
        st = DycoreState.from_analytic_init(w.metric_terms, device="cpu", dtype=torch.float64)
        args = {k: v for k, v in st.to_numpy().items()
                if k in ("u", "v", "w", "delz", "pt", "delp", "ps", "pe", "pk", "peln", "pkz",
                         "phis")}
        args["q"] = st.q.numpy()[:, :7]
        outs[tag] = (w(**args), w, st)
    w_cpu, st = outs["cpu"][1], outs["cpu"][2]
    as_state = {tag: SimpleNamespace(**{nm: torch.from_numpy(o[0][nm]) if nm in o[0] else None
                                        for nm in STEP_FIELDS}) for tag, o in outs.items()}
    hold_f64("GEOS wrapper, 1 step", as_state["card"], as_state["cpu"],
             step_f64_scales(SimpleNamespace(state=st, grid=w_cpu.grid, core=w_cpu.dycore),
                             constants), setup="C12 npz=6 f64")
    log(f"[wall] section 8 (queue 1 item 3) took {time.perf_counter() - t_sec:.1f} s")
    return tc_launches

#: [mesh 3 ranks]: baroclinic_c192.yaml's config cut to C48 on layout [2, 2]
#: (24 shards, 8 a rank) for 2 steps, three processes on the one card; and
#: its f64 check, C12 npz=8 with consv_te for 1 step (on the CPU a step of
#: 56 substeps takes about 15 s), against the CPU's one process
MESH_RANKS = 3
MESH_N = 48
MESH_LAYOUT = [2, 2]
MESH_STEPS = 2
MESH_F64_N, MESH_F64_NPZ, MESH_F64_STEPS = 12, 8, 1


def kernel_counters():
    """Every kernel's launch counter, by kernel name (the modules' LAUNCHES
    dicts: clear them to zero a run's counts)."""
    from pace_tpu_torch.ops import (c_sw_tail_kernel, d2a2c_kernel, d_sw_tail_kernel,
                                    fvtp2d_kernel, hydro_kernel, pgrad_kernel, remap_kernel,
                                    sim1_kernel, updatedz_kernel)
    from pace_tpu_torch.parallel import halo_kernel

    return {"halo": halo_kernel.LAUNCHES, "fvtp2d": fvtp2d_kernel.LAUNCHES,
            "fvtp2d_tracer": fvtp2d_kernel.LAUNCHES, "d2a2c": d2a2c_kernel.LAUNCHES,
            "c_sw_tail": c_sw_tail_kernel.LAUNCHES, "hydro": hydro_kernel.LAUNCHES,
            "heights": updatedz_kernel.LAUNCHES, "updatedz_c": updatedz_kernel.LAUNCHES,
            "sim1": sim1_kernel.LAUNCHES, "fvtp2d_multi": fvtp2d_kernel.LAUNCHES,
            "d_sw_tail": d_sw_tail_kernel.LAUNCHES,
            "flux_height_update": updatedz_kernel.LAUNCHES, "pgrad": pgrad_kernel.LAUNCHES,
            "remap": remap_kernel.LAUNCHES}


def zero_counters():
    """Every count of :func:`kernel_counters` set to 0."""
    for c in kernel_counters().values():
        for k in c:
            c[k] = 0


def mesh_configs(configs, n, npz, build_dir):
    """The raw configs of [mesh 3 ranks]: ``c48`` (f32, C48 by default) and
    ``f64`` (C12 npz=8, consv_te), each with the mesh on; outputs under
    ``build_dir``, no stage profile (three profilers on one card)."""
    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.utils import yaml_subset

    with open(os.path.join(configs, "baroclinic_c192.yaml")) as f:
        base = yaml_subset.safe_load(f)
    out = {}
    for tag, nx, nz, prec, steps in (("c48", n, npz, 32, MESH_STEPS),
                                     ("f64", MESH_F64_N, MESH_F64_NPZ, 64, MESH_F64_STEPS)):
        raw = json.loads(json.dumps(base))
        raw.update(nx_tile=nx, nz=nz, layout=list(MESH_LAYOUT), precision=prec, minutes=0,
                   seconds=steps * base["dt_atmos"], mesh_config={"enabled": True})
        raw["dycore_config"].update(ddemo.STABLE_DAMPING)
        if tag == "f64":
            raw["dycore_config"]["consv_te"] = 1.0
        raw["diagnostics_config"].update(path=os.path.join(build_dir, tag, "output"),
                                         output_format=DIAGNOSTICS_FORMAT,
                                         output_frequency=1000)
        raw["performance_config"].update(
            experiment_name=os.path.join(build_dir, tag, "exp"), collect_stage_times=False)
        out[tag] = raw
    return out


def mesh_rank_main(argv) -> int:
    """One rank of [mesh 3 ranks] (``chip_smoke.py --mesh-rank R --mesh-job
    JOB.json``): joins the process group of the file rendezvous in the job,
    runs each of the job's configs through the Driver on the card, and
    writes its launch counts and step times; rank 0 writes the gathered
    state of each."""
    rank = int(argv[argv.index("--mesh-rank") + 1])
    with open(argv[argv.index("--mesh-job") + 1]) as f:
        job = json.load(f)
    sys.path.insert(0, HERE)
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver
    from pace_tpu_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    device = job["device"]
    M.initialize_distributed(device, init_method=job["rendezvous"], world_size=job["ranks"],
                             rank=rank)
    counters = kernel_counters()
    report = {}
    for tag, raw in job["configs"].items():
        zero_counters()
        t0 = time.perf_counter()
        drv = Driver(DriverConfig.from_dict(raw), device=device)
        drv.step_all()
        drv.cleanup()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        whole = drv._whole(drv.state)
        report[tag] = {"launches": {k: c[k] for k, c in counters.items()},
                       "step_ms": [1e3 * t for t in drv.performance.step_seconds],
                       "wall_s": wall, "backend": drv.mesh.backend,
                       "host_staged": drv.mesh.host_staged, "k": drv.mesh.k,
                       "steps": drv._step_count}
        if rank == 0:
            with open(os.path.join(job["out"], f"{tag}.npz"), "wb") as f:
                np.savez(f, **{fl.name: getattr(whole, fl.name).cpu().numpy()
                               for fl in dataclasses.fields(whole)
                               if getattr(whole, fl.name) is not None})
        del drv, whole
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def comm_mesh_phases(dev, counters, zero_counters, out_root, configs, c192, n=N, npz=NPZ,
                     mesh_n=MESH_N, comm_npz=None):
    """Section 9: what ROADMAP queue 1 items 7 and 8 added, through the
    user's entry points: the three comm configs ([comm]), the C192 driver
    config on a mesh of one NCCL rank ([mesh 1 rank]) and C48 on three
    gloo ranks sharing the card ([mesh 3 ranks]). ``c192`` holds
    [driver baroclinic_c192]'s final state (on the host), mainloop ms/step
    and launches. Returns the row-1 launches a step on each mesh path."""
    import torch.distributed as dist

    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver
    from pace_tpu_torch.utils import yaml_subset

    t_sec = time.perf_counter()
    build_dir = os.path.join(HERE, "build", "section9")
    shutil.rmtree(build_dir, ignore_errors=True)
    os.makedirs(build_dir)

    def read_yaml(name):
        with open(os.path.join(configs, name)) as f:
            return yaml_subset.safe_load(f)

    def fields_of(state):
        return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None}

    # --- [comm]: the three comm configs as written (C12, npz=39,
    #     hydrostatic, k_split=1, n_split=2, 4 steps), the recording kept
    #     under build/ (it is about 100 MB)
    def comm_raw(name, tag, path=None):
        raw = read_yaml(name)
        if comm_npz is not None:
            raw["nz"] = comm_npz
        raw["diagnostics_config"].update(path=os.path.join(out_root, "comm", tag, "output"),
                                         output_format=DIAGNOSTICS_FORMAT)
        raw.setdefault("performance_config", {})["experiment_name"] = os.path.join(
            out_root, "comm", tag, "exp")
        if path is not None:
            raw["comm_config"]["path"] = path
        return raw

    rec_card = os.path.join(build_dir, "halo_recording.npz")
    rec_cpu = os.path.join(build_dir, "halo_recording_cpu.npz")
    comm = {}
    for tag, name, d, path in (("write", "baroclinic_c12_comm_write.yaml", dev, rec_card),
                               ("read", "baroclinic_c12_comm_read.yaml", dev, rec_card),
                               ("write cpu", "baroclinic_c12_comm_write.yaml", "cpu", rec_cpu)):
        zero_counters()
        t0 = time.perf_counter()
        drv = Driver(DriverConfig.from_dict(comm_raw(name, tag.replace(" ", "_"), path)),
                     device=d)
        drv.step_all()
        drv.cleanup()
        comm[tag] = dict(driver=drv, launches={k: c[k] for k, c in counters.items()},
                         wall=time.perf_counter() - t0)
    raw_null = comm_raw("baroclinic_c12_null_comm.yaml", "null")
    zero_counters()
    drv = Driver(DriverConfig.from_dict(raw_null), device=dev)
    try:
        drv.step_all()
        null_stop = None
    except RuntimeError as e:
        null_stop = (drv._step_count, str(e))
    drv.diagnostics.cleanup()
    null_launch = {k: c[k] for k, c in counters.items()}
    raw_null["safety_checks"] = []
    raw_null["diagnostics_config"]["path"] += "_unchecked"
    zero_counters()
    drv = Driver(DriverConfig.from_dict(raw_null), device=dev)
    drv.step_all()
    drv.cleanup()
    comm["null"] = dict(driver=drv, launches={k: c[k] for k, c in counters.items()})
    with np.load(rec_card) as a, np.load(rec_cpu) as b:
        ops_card, ops_cpu = [str(x) for x in a["ops"]], [str(x) for x in b["ops"]]
    w, r = comm["write"]["driver"], comm["read"]["driver"]
    differ = [nm for nm, t in fields_of(w.state).items()
              if not same_bits(t, getattr(r.state, nm))]
    cfg_w = w.config
    log(f"[comm] baroclinic_c12_comm_write.yaml as written (C{cfg_w.nx_tile} npz={cfg_w.nz}, "
        f"k_split={cfg_w.dycore_config.k_split}, n_split={cfg_w.dycore_config.n_split}, "
        f"{w._step_count} steps): {len(ops_card)} exchange results recorded, halo launches "
        f"{comm['write']['launches']['halo']}, {comm['write']['wall']:.1f} s; the port on the "
        f"CPU records {len(ops_cpu)} with the same tags in the same order: {ops_card == ops_cpu}")
    log(f"[comm] baroclinic_c12_comm_read.yaml replaying it: {r.halo._i} of {len(r.halo._ops)} "
        f"results used, halo launches {comm['read']['launches']['halo']}, the final state "
        f"bit-identical to the write run's: {not differ}"
        f"{' (differ: ' + ', '.join(differ) + ')' if differ else ''}")
    log(f"[comm] baroclinic_c12_null_comm.yaml as written: "
        + (f"its safety checks stop it after step {null_stop[0]} ({null_stop[1][:90]}), as "
           "pace_tpu's stop it" if null_stop else "ran to its end")
        + f", halo launches {null_launch['halo']}; without the safety checks "
        f"{comm['null']['driver']._step_count} steps, halo launches "
        f"{comm['null']['launches']['halo']}")
    bad = []
    if ops_card != ops_cpu:
        bad.append("the card's recording differs from the CPU's in its tags")
    if differ or r.halo._i != len(r.halo._ops):
        bad.append(f"the read run is not the write run: {differ}")
    if comm["write"]["launches"]["halo"] <= 0 and dev.type == "cuda":
        bad.append("the write run launched no halo kernel")
    if comm["read"]["launches"]["halo"] or null_launch["halo"] or comm["null"]["launches"]["halo"]:
        bad.append("a run with the exchange stood in for launched the halo kernel")
    if null_stop is None or null_stop[0] != 1 or "NaN detected" not in null_stop[1]:
        bad.append(f"the null config did not stop as pace_tpu's does: {null_stop}")
    if comm["null"]["driver"]._step_count != cfg_w.n_timesteps:
        bad.append("the null config without safety checks did not run its steps")
    if bad:
        raise AssertionError("[comm] checks failed: " + "; ".join(bad))
    del comm, w, r, drv
    os.remove(rec_cpu)

    # --- [mesh 1 rank]: [driver baroclinic_c192]'s config with the mesh on,
    #     one NCCL rank
    raw = read_yaml("baroclinic_c192.yaml")
    raw.update(nx_tile=n, nz=npz, minutes=DRIVER_C192_MINUTES, mesh_config={"enabled": True})
    raw["dycore_config"].update(ddemo.STABLE_DAMPING)
    m1_dir = os.path.join(out_root, "mesh_1_rank")
    raw["diagnostics_config"].update(path=os.path.join(m1_dir, raw["diagnostics_config"]["path"]),
                                     output_format=DIAGNOSTICS_FORMAT)
    raw["performance_config"].update(
        experiment_name=os.path.join(m1_dir, raw["performance_config"]["experiment_name"]),
        collect_communication=True)
    if not dist.is_nccl_available():
        log("[mesh 1 rank] this card's PyTorch has no NCCL: the phase fails (no other backend "
            "is taken)")
        raise AssertionError("[mesh 1 rank] torch.distributed.is_nccl_available() is false")
    zero_counters()
    drv = Driver(DriverConfig.from_dict(raw), device=dev)
    drv.step_all()
    drv.cleanup()
    m1_launches = {k: c[k] for k, c in counters.items()}
    report = drv.performance.report(drv.config.dt_atmos)
    m1_ms = 1e3 * report["mainloop_mean_seconds"]
    differ = [nm for nm, t in fields_of(drv.state).items()
              if nm not in c192["state"] or not same_bits(t.cpu(), c192["state"][nm])]
    n_calls = drv._step_count + 1
    log(f"[mesh 1 rank] baroclinic_c192.yaml's config (C{n} npz={npz} f32, STABLE_DAMPING, "
        f"{drv._step_count} steps) with mesh_config.enabled: backend {drv.mesh.backend}, "
        f"{drv.mesh.k} shards on rank 0 of {drv.mesh.world_size}; mainloop {m1_ms:.3f} ms/step "
        f"(ms: {', '.join(f'{1e3 * t:.3f}' for t in drv.performance.step_seconds)}) against "
        f"[driver baroclinic_c192]'s {c192['ms']:.3f} ms/step in this call")
    log(f"[mesh 1 rank] state against [driver baroclinic_c192]'s: "
        f"{len(fields_of(drv.state)) - len(differ)} of {len(fields_of(drv.state))} fields "
        f"bit-identical{': differ ' + ', '.join(differ) if differ else ''}; launches in "
        f"{n_calls} step calls {m1_launches}, equal to [driver baroclinic_c192]'s: "
        f"{m1_launches == c192['launches']}; halo launches a step call "
        f"{m1_launches['halo'] / n_calls:.1f}")
    bad = []
    if drv.mesh.backend != "nccl":
        bad.append(f"backend {drv.mesh.backend}")
    if differ:
        bad.append(f"fields differ from the unmeshed run: {differ}")
    if m1_launches != c192["launches"]:
        bad.append("launches differ from the unmeshed run's")
    if bad:
        raise AssertionError("[mesh 1 rank] checks failed: " + "; ".join(bad))
    shutil.rmtree(drv.config.diagnostics_config.path, ignore_errors=True)
    del drv
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # --- [mesh 3 ranks]: three processes on the one card (gloo, the halo
    #     frames through host buffers), the kernels built already; against
    #     one process of the same config
    mesh_raw = mesh_configs(configs, mesh_n, npz, build_dir)
    single = json.loads(json.dumps(mesh_raw["c48"]))
    single["mesh_config"] = {"enabled": False}
    zero_counters()
    t0 = time.perf_counter()
    ref = Driver(DriverConfig.from_dict(single), device=dev)
    ref.step_all()
    ref.cleanup()
    ref_wall = time.perf_counter() - t0
    ref_launches = {k: c[k] for k, c in counters.items()}
    ref_ms = [1e3 * t for t in ref.performance.step_seconds]
    ref_state = {nm: t.cpu() for nm, t in fields_of(ref.state).items()}
    del ref
    torch.cuda.empty_cache()
    job = {"rendezvous": f"file://{os.path.join(build_dir, 'rendezvous')}",
           "ranks": MESH_RANKS, "out": build_dir, "configs": mesh_raw, "device": dev.type}
    job_path = os.path.join(build_dir, "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, WORLD_SIZE=str(MESH_RANKS), LOCAL_WORLD_SIZE=str(MESH_RANKS))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mesh-rank", str(r),
         "--mesh-job", job_path], cwd=HERE, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall3 = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[mesh 3 ranks] rank {r} failed:\n{text[-6000:]}")
    reports = []
    for r in range(MESH_RANKS):
        with open(os.path.join(build_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    with np.load(os.path.join(build_dir, "c48.npz")) as f:
        got = {nm: torch.from_numpy(f[nm]) for nm in f.files}
    differ = [nm for nm, t in ref_state.items()
              if nm not in got or not same_bits(ring(got[nm], 3), ring(t, 3))]
    c48 = [rep["c48"] for rep in reports]
    steps3 = c48[0]["steps"]
    m3_halo = [rep["launches"]["halo"] / steps3 for rep in c48]
    missing = [k for rep in c48 for k, v in rep["launches"].items()
               if v <= 0 and dev.type == "cuda"]
    # each rank makes every exchange and runs every kernel on its block as
    # one process does on the whole cube: the same launches
    off = {r: {k: (v, ref_launches[k]) for k, v in rep["launches"].items()
               if v != ref_launches[k]} for r, rep in enumerate(c48)}
    off = {r: d for r, d in off.items() if d}
    cfg48 = DriverConfig.from_dict(single)
    log(f"[mesh 3 ranks] baroclinic_c192.yaml's config cut to C{cfg48.nx_tile} npz={cfg48.nz} "
        f"f32 on layout {MESH_LAYOUT} ({6 * MESH_LAYOUT[0] * MESH_LAYOUT[1]} shards, "
        f"{c48[0]['k']} a rank), {steps3} steps, {MESH_RANKS} processes on the one card "
        f"(backend {c48[0]['backend']}, frames through host buffers: {c48[0]['host_staged']}): "
        f"wall of the three processes {wall3:.1f} s (start-up, both configs and the "
        f"gathers included), each rank's wall of the C{cfg48.nx_tile} run "
        f"{', '.join('%.1f' % rep['wall_s'] for rep in c48)} s, step ms "
        f"{[[round(t, 3) for t in rep['step_ms']] for rep in c48]}; one process: wall "
        f"{ref_wall:.1f} s, step ms {[round(t, 3) for t in ref_ms]}")
    log(f"[mesh 3 ranks] interior (3 rings in) against one process: "
        f"{len(ref_state) - len(differ)} of {len(ref_state)} fields bit-identical"
        f"{': differ ' + ', '.join(differ) if differ else ''}; halo launches a step on each "
        f"rank {m3_halo} (one process: {ref_launches['halo'] / steps3:.1f}); launches of "
        f"rank 0: {c48[0]['launches']}; every rank's equal to one process's: {not off}")
    bad = []
    if differ:
        worst = {nm: float((ring(got[nm], 3).double() - ring(ref_state[nm], 3).double()).abs()
                           .max()) for nm in differ if nm in got}
        bad.append(f"fields differ from one process: {worst}")
    if missing:
        bad.append(f"kernels not launched on a rank: {sorted(set(missing))}")
    if off:
        bad.append(f"launches (rank: {{kernel: (rank's, one process's)}}) {off}")
    # the f64 config with consv_te, against the CPU's one process
    f64_single = json.loads(json.dumps(mesh_raw["f64"]))
    f64_single["mesh_config"] = {"enabled": False}
    cpu = Driver(DriverConfig.from_dict(f64_single), device="cpu")
    start = cpu.state
    cpu.step_all()
    cpu.cleanup()
    from pace_tpu_torch import constants

    # w, delz and omga at the scale a difference of pressures near 1e5 Pa
    # sets, as [driver f64] holds them
    f64_scales = step_f64_scales(SimpleNamespace(state=start, grid=cpu.grid_data,
                                                 core=cpu.dycore), constants)
    with np.load(os.path.join(build_dir, "f64.npz")) as f:
        card = SimpleNamespace(**{nm: (torch.from_numpy(f[nm]) if nm in f.files else None)
                                  for nm in STEP_FIELDS})
    hold_f64(f"{MESH_RANKS} ranks, baroclinic_c192.yaml's config with consv_te on layout "
             f"{MESH_LAYOUT}, {MESH_F64_STEPS} step", card, cpu.state, f64_scales,
             setup=f"C{MESH_F64_N} npz={MESH_F64_NPZ} f64")
    if bad:
        raise AssertionError("[mesh 3 ranks] checks failed: " + "; ".join(bad))
    shutil.rmtree(build_dir, ignore_errors=True)
    log(f"[wall] section 9 (comm configs and the mesh) took {time.perf_counter() - t_sec:.1f} s")
    return {"mesh_1_rank": m1_launches, "mesh_1_rank_calls": n_calls,
            "mesh_3_ranks_halo_per_step": m3_halo}


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
    halo_err = max(check_halo(label, {k: hk._lift(v) for k, v in inputs.items()}, plan)
                   for label, plan, inputs in halo_cases)

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
        tracer_against_single(label, args)
        tr_err = max(tr_err, check_fvtp2d_tracer(label, *args))
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
    d_got, d_err = check_d2a2c(f"C{n}", *d_args)
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
    del _ut, _vt
    uc, vc = chalo.sync_vector_interfaces(uc, vc, kind="cgrid")
    uc_x, vc_x = chalo.update_vector(uc, vc, kind="cgrid", fold="x")
    uc_y, vc_y = chalo.update_vector(uc, vc, kind="cgrid", fold="y")
    ua_y, va_x = chalo.update_vector_fold_pair(ua, va, kind="agrid")
    t_args = (u_y, v_x, delp_x, pt_x, uc, vc, uc_x, vc_x, uc_y, vc_y, ua, va, va_x, ua_y,
              cgrid, dt2)
    t_got, t_err = check_c_sw_tail(f"C{n}", *t_args)
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
        check_halo(label, {k: hk._lift(v) for k, v in inputs.items()}, plan)
    del ref, lifted, new_plans, uc_x, vc_x, uc_y, vc_y, ua_y, va_x, ua, va, uc, vc
    del t_args, d_args, d_got, u_y, v_x, delp_x, pt_x, divg

    # hydrostatic chain on the provisional C-grid state
    delpc, ptc = t_got[0], t_got[1]
    del t_got
    K = delpc.shape[1]
    h_all = ("pe", "peln", "pk", "pkz", "gz")
    h_got, h_err = check_hydro(f"C{n}", delpc, ptc, st.phis, cgrid.ptop, need=h_all)
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
    del h_got, pruned, delpc, ptc
    torch.cuda.empty_cache()

    # --- the nonhydrostatic vertical's kernels, on the fields of one
    #     nonhydrostatic half step from the same state
    ncase = dataclasses.replace(ccase, config=cdemo.AcousticConfig(hydrostatic=False),
                                phis_folds=chalo.update_scalar_folds(st.phis))
    nhalf = cdemo.step(ncase)
    torch.cuda.synchronize()
    area = cgrid.area

    # interface heights of the exchanged delz (x fold)
    z_args = (nhalf.delz_x, nhalf.phis_folds[0])
    z_got, z_ref, z_err = check_heights(f"C{n}", *z_args)
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
    del z_got, z_ref, flipped

    # updatedz_c on the heights of both folds and c_sw's area fluxes; the
    # outermost ring is unspecified
    u_args = (nhalf.zh_x, nhalf.zh_y, nhalf.cg.xfx, nhalf.cg.yfx, area, dt2)
    u_got, u_err = check_updatedz_c(f"C{n}", *u_args)
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
    del u_got, zh_c
    p_fac = ncase.config.p_fac

    s_got, s_err = check_sim1_kernel(f"C{n}", *s_args, dt2, cgrid.ptop, p_fac)
    # the θ-blend's instantiation (a_imp != 1) on the same operands, by the
    # same gate; its time beside the backward-Euler form's
    check_sim1_kernel(f"C{n} a_imp=0.75", *s_args, dt2, cgrid.ptop, p_fac, a_imp=0.75)
    blend_ms = time_ms(lambda: s1k.sim1_solver_cuda(*s_args, dt2, cgrid.ptop, p_fac=p_fac,
                                                    a_imp=0.75), 20)
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
            ref = sim1_plain(*args, dt2, cgrid.ptop, p_fac)
            torch.cuda.synchronize()
            tol = (dict.fromkeys(("w", "delz", "pp"), 4 * ulp) if dtype == f32
                   else SIM1_F64_REL_TOL)
            for nm, a, b in zip(("w", "delz", "pp"), got, ref):
                check_close(f"sim1 {label} {str(dtype)[6:]} {nm} on a {tuple(a.shape)} plane "
                            f"({s1k.tile_columns(K_, dtype)} columns a block)", a, b,
                            tol[nm] * float(b.abs().max()))
    del limits, args, got, ref
    ms = time_ms(lambda: s1k.sim1_solver_cuda(*s_args, dt2, cgrid.ptop, p_fac=p_fac), 20)
    plain_ms = time_ms(lambda: sim1_plain(*s_args, dt2, cgrid.ptop, p_fac), 2)
    b_ms, b_by = bound(nbytes(*s_args, *s_got), SIM1_OPS_PER_POINT * s_args[0].numel(), f32)
    # max_abs_err of the line: pp's [Pa], the pressure gradient's operand
    results["sim1"] = dict(max_abs_err=s_err["pp"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
    log(f"[time] sim1 {tuple(s_args[0].shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the kernel's time; "
        f"the θ-blend form (a_imp=0.75) {blend_ms:.4f} ms")
    del s_got, s_args, u_args, z_args, nhalf, ncase, area
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
    # w = 0 in the analytic state: its fluxes are exactly zero on both sides
    m_got, m_errs = check_fvtp2d_multi(f"C{n}", *m_args, mfx=mfx, mfy=mfy,
                                       names=("pt", "vort", "w"))
    m_err = m_errs[0]
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
    del m_in, m_out

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
        t_got, t_err = check_d_sw_tail(label, *t_args)
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
        del t_got, t_args
    del vfx, vfy, dvfx, dvfy, vort, vort_x, vort_p, ut, vt, divg, tail_cases

    # the flux-form height update, as updatedz_d calls it: interface-averaged
    # fluxes and the hord-5 fluxes of the heights over K+1 interfaces
    crx_i, cry_i, xfx_i, yfx_i = (nh_ops._to_iface(f) for f in (crx, cry, xfx, yfx))
    del crx, cry, xfx, yfx, mfx, mfy
    fl = fvtp2d_best(chalf.zh_x, chalf.zh_y, crx_i, cry_i, xfx_i, yfx_i, sgrid.area, 5)
    f_args = (chalf.zh_x, fl.fx, fl.fy, xfx_i, yfx_i, sgrid.area)
    f_got, f_err = check_flux_height_update(f"C{n}", *f_args)
    ms = time_ms(lambda: uzk.flux_height_update_cuda(*f_args), 20)
    plain_ms = time_ms(lambda: nh_ops.flux_height_update_plain(*f_args), 3)
    b_ms, b_by = bound(nbytes(*f_args, f_got), FLUX_HEIGHT_OPS_PER_POINT * f_got.numel(), f32)
    results["flux_height_update"] = dict(max_abs_err=f_err, ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time] flux_height_update {tuple(f_got.shape)} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del f_got, f_args, fl, crx_i, cry_i, xfx_i, yfx_i

    # the nonhydrostatic D-grid pressure gradient on the substep's own
    # operands
    p_args = (dhalf.u, dhalf.v, dhalf.pk, dhalf.gz, dhalf.pp, dhalf.delp, sgrid, dt)
    p_got, p_err = check_nh_p_grad(f"C{n}", *p_args, four_ulp=True)
    S_, K_, Y_, X_ = dhalf.delp.shape
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
    del p_got, p_args, p_consts, chalf, dhalf, scase, sgrid, shalo, st
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
    def check_step_f64(label, card, cpu, note="", qcld_scale=None, field_scales=None,
                       setup="C24 npz=8 f64", split=" (k_split=2, n_split=2)"):
        """Each of STEP_FIELDS of the card's state within STEP_F64_REL_TOL
        of its scale of the CPU's, on the compute domain, or raise. With
        ``qcld_scale``, the tracer block is held without qcld, and qcld on
        its own to the larger of its maximum and ``qcld_scale``.
        ``field_scales`` replaces this section's ``scales`` (for another
        configuration than its C24 step)."""
        sc = scales if field_scales is None else field_scales
        pairs = {nm: (getattr(card, nm).cpu(), getattr(cpu, nm), sc.get(nm, 0.0))
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
            scale = max(float(y.abs().max()), extra, 1e-300)
            worst[nm] = float((x - y).abs().max()) / scale
        log(f"[check] {setup} {label}{split}, card kernels vs CPU plain "
            f"path: {note}max diff over each field's scale: "
            + ", ".join(f"{nm} {r:.3e}" for nm, r in worst.items()))
        bad = {nm: r for nm, r in worst.items() if not r <= STEP_F64_REL_TOL}
        if bad:
            raise AssertionError(f"{setup} {label} departs from the CPU reference: {bad}")

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
    counters = kernel_counters()
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

    # ------------------------------------------------------------------
    # 7. the driver: examples/configs/baroclinic_c192.yaml through the
    #    port's Driver (this slice's main path), the command line on
    #    earthlike_c24.yaml, and one driver config on the card and the CPU
    # ------------------------------------------------------------------
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver
    from pace_tpu_torch.models.fv3.state import DycoreState
    from pace_tpu_torch.utils import native, netcdf3, yaml_subset

    log(f"[driver] the native IO core of the NetCDF-3 codec (utils/_native/nc3core.cpp, g++) "
        f"loaded: {native.available()}")
    for res in (stout, h_out, hs_out, e_out, p_out, sa_out, el_out):
        res.pop("case", None)
    torch.cuda.empty_cache()
    t_drv = time.perf_counter()
    out_root = os.path.join(HERE, "chiprun_out", "driver")
    shutil.rmtree(out_root, ignore_errors=True)
    configs = os.path.join(HERE, "examples", "configs")

    def read_yaml(name):
        with open(os.path.join(configs, name)) as f:
            return yaml_subset.safe_load(f)

    def diagnostics_records(path):
        return {nm: torch.from_numpy(np.asarray(v.data, dtype=np.float32))
                for nm, v in netcdf3.read(os.path.join(path, "diagnostics.nc")).variables.items()}

    # --- [driver baroclinic_c192]: the yaml as written, but STABLE_DAMPING
    #     (its damping diverges, ROADMAP queue 3), 20 minutes (6 steps, one
    #     diagnostics record), the HaloExchange stage split out, and the
    #     outputs under chiprun_out/
    c192_dir = os.path.join(out_root, "baroclinic_c192")
    raw = read_yaml("baroclinic_c192.yaml")
    raw.update(nx_tile=n, nz=npz, minutes=DRIVER_C192_MINUTES)
    raw["dycore_config"].update(ddemo.STABLE_DAMPING)
    dcfg = raw["diagnostics_config"]
    dcfg.update(path=os.path.join(c192_dir, dcfg["path"]), output_format=DIAGNOSTICS_FORMAT)
    pcfg = raw["performance_config"]
    pcfg.update(experiment_name=os.path.join(c192_dir, pcfg["experiment_name"]),
                collect_communication=True)
    cfg = DriverConfig.from_dict(raw)
    drv = Driver(cfg, device=dev)
    # the tracer sub-cycles of every step the driver takes (the mainloop's
    # and the stage profile's), for the launch table
    subcycles = []
    core_step = drv.dycore.step_dynamics

    def recorded_step(state_):
        new = core_step(state_)
        subcycles.append(list(drv.dycore.tracer_subcycles))
        return new

    drv.dycore.step_dynamics = recorded_step
    zero_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    drv.step_all()
    drv.cleanup()
    drv_launches = {k: c[k] for k, c in counters.items()}
    drv_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    report = drv.performance.report(cfg.dt_atmos)
    dyc = cfg.dycore_config
    n_drv = len(subcycles)
    per = {"substep": n_drv * dyc.k_split * dyc.n_split, "outer": n_drv * dyc.k_split,
           "subcycle": sum(map(sum, subcycles)), "step": n_drv}
    want = {k: 0 for k in counters}
    for kind, table in STEP_LAUNCHES.items():
        for k, v in table.items():
            want[k] += v * per[kind]
    failures = []
    if drv._step_count != cfg.n_timesteps or n_drv != cfg.n_timesteps + 1:
        failures.append(f"{drv._step_count} steps of {cfg.n_timesteps}, {n_drv} step calls")
    failures += [f"kernel {k} launched {drv_launches[k]} times, expected {c}"
                 for k, c in want.items() if drv_launches[k] != c]
    failures += [f"kernel {k} not on the driver's path" for k, c in drv_launches.items()
                 if c <= 0]
    # six direct steps from the analytic state on the same grid: the driver
    # adds nothing to the numbers
    ref_core = DynamicalCore(drv.grid_data, drv.halo, dyc, cfg.dt_atmos)
    ref = DycoreState.from_analytic_init(drv.metric_terms, case="baroclinic", perturbation=True,
                                         device=dev, dtype=f32)
    for _ in range(cfg.n_timesteps):
        ref = ref_core.step_dynamics(ref)
    fields = [f.name for f in dataclasses.fields(ref)]
    differ = [nm for nm in fields
              if (getattr(ref, nm) is None) != (getattr(drv.state, nm) is None)
              or (getattr(ref, nm) is not None and not same_bits(getattr(ref, nm),
                                                                  getattr(drv.state, nm)))]
    del ref, ref_core
    recs = diagnostics_records(cfg.diagnostics_config.path)
    diag_names = ("ps", "ua", "va", "pt", "lat", "lon", "time")
    bad_diag = [nm for nm in diag_names
                if nm not in recs or not bool(torch.isfinite(recs[nm]).all())]
    perf_json = f"{cfg.performance_config.experiment_name}_perf.json"
    stages = drv.performance.stage_device_seconds
    log(f"[driver baroclinic_c192] C{n} npz={npz} f32 k_split={dyc.k_split} "
        f"n_split={dyc.n_split}, {drv._step_count} steps of {cfg.dt_atmos:.0f} s: mainloop "
        f"{1e3 * report['mainloop_mean_seconds']:.3f} ms/step over steps 2-{drv._step_count} "
        f"(ms: {', '.join(f'{1e3 * t:.3f}' for t in drv.performance.step_seconds)}), SYPD "
        f"{report['SYPD']:.5f}, against [step]'s {stout['ms_per_step']:.3f} ms/step in this "
        f"call; peak memory {drv_peak:.2f} GB")
    log(f"[driver baroclinic_c192] launches in {n_drv} step calls (the mainloop's "
        f"{drv._step_count} and the stage profile's one): {drv_launches}")
    log(f"[driver baroclinic_c192] state after {drv._step_count} steps against as many direct "
        f"step_dynamics calls from DycoreState.from_analytic_init: {len(fields) - len(differ)} "
        f"of {len(fields)} fields bit-identical{': differ ' + ', '.join(differ) if differ else ''}"
        f"; diagnostics {sorted(recs)} ({int(recs['ps'].shape[0]) if 'ps' in recs else 0} "
        f"record), finite: {not bad_diag}; {os.path.basename(perf_json)} written: "
        f"{os.path.exists(perf_json)}")
    if stages:
        named = {k: v for k, v in stages.items() if k != "other"}
        log("[driver baroclinic_c192] stage device times of one step (collect_communication): "
            + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in stages.items())
            + f"; the stages' sum {1e3 * sum(named.values()):.3f} ms of the profiled step's "
            f"{1e3 * sum(stages.values()):.3f} ms of device time")
    else:
        log("[driver baroclinic_c192] stage device times: the profiler recorded no device "
            "time: not measured")
    if differ:
        failures.append(f"fields differ from the direct steps: {differ}")
    if bad_diag or int(recs["ps"].shape[0]) != 1:
        failures.append(f"diagnostics missing or not finite: {bad_diag}")
    if not os.path.exists(perf_json):
        failures.append(f"{perf_json} not written")
    if failures:
        raise AssertionError("[driver baroclinic_c192] checks failed: " + "; ".join(failures))
    # the C192 record (about 280 MB) is not kept: the outputs under
    # chiprun_out/ stay small enough to copy back from the card's machine
    shutil.rmtree(cfg.diagnostics_config.path)
    # what [mesh 1 rank] (section 9) is held to: the final state, on the host
    c192 = {"state": {f.name: getattr(drv.state, f.name).cpu()
                      for f in dataclasses.fields(drv.state)
                      if getattr(drv.state, f.name) is not None},
            "ms": 1e3 * report["mainloop_mean_seconds"], "launches": drv_launches}
    del drv, recs
    torch.cuda.empty_cache()

    # --- [driver cli earthlike_c24]: the user's command on the yaml as
    #     written, in a fresh directory (a copy that differs only in the
    #     diagnostics' output_format where h5py is missing)
    cli_dir = os.path.join(out_root, "cli_earthlike_c24")
    os.makedirs(cli_dir)
    with open(os.path.join(configs, "earthlike_c24.yaml")) as f:
        text = f.read()
    if DIAGNOSTICS_FORMAT != "hdf5":
        text = text.replace("diagnostics_config:\n",
                            f"diagnostics_config:\n  output_format: {DIAGNOSTICS_FORMAT}\n", 1)
        a, b = read_yaml("earthlike_c24.yaml"), yaml_subset.load(text)
        b["diagnostics_config"].pop("output_format")
        if a != b:
            raise AssertionError("the copy of earthlike_c24.yaml differs in more than "
                                 "output_format")
    yaml_copy = os.path.join(cli_dir, "earthlike_c24.yaml")
    with open(yaml_copy, "w") as f:
        f.write(text)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    proc = subprocess.run(
        [sys.executable, "-m", "pace_tpu_torch.driver.run", yaml_copy, "--device", dev.type],
        cwd=cli_dir, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(cli_dir, "run.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    tail = [ln for ln in proc.stdout.splitlines() if "mainloop" in ln or "running" in ln]
    log(f"[driver cli earthlike_c24] python -m pace_tpu_torch.driver.run earthlike_c24.yaml: "
        f"rc {proc.returncode} in {cli_s:.1f} s; " + " | ".join(tail))
    failures = []
    if proc.returncode != 0:
        failures.append(f"rc {proc.returncode}: {proc.stderr[-3000:]}")
    else:
        recs = diagnostics_records(os.path.join(cli_dir, "output_earthlike"))
        for nm in ("ps", "ua", "precipitation", "tskin"):
            if nm not in recs or recs[nm].shape[0] != 2 or not bool(torch.isfinite(recs[nm]).all()):
                failures.append(f"{nm}: not 2 finite records")
        if "tskin" in recs:
            tsk = recs["tskin"]
            log(f"[driver cli earthlike_c24] diagnostics {sorted(recs)}: ps records "
                f"{tuple(recs['ps'].shape)}, tskin in [{float(tsk.min()):.3f}, "
                f"{float(tsk.max()):.3f}] K (allowed {TSKIN_RANGE}), precipitation up to "
                f"{float(recs['precipitation'].max()):.4e} kg/m^2/s")
            if not TSKIN_RANGE[0] <= float(tsk.min()) <= float(tsk.max()) <= TSKIN_RANGE[1]:
                failures.append(f"tskin range [{float(tsk.min())}, {float(tsk.max())}]")
        if not os.path.exists(os.path.join(cli_dir, "earthlike_c24_perf.json")):
            failures.append("earthlike_c24_perf.json not written")
    if failures:
        raise AssertionError("[driver cli earthlike_c24] checks failed: " + "; ".join(failures))

    # --- [driver f64]: earthlike_c24.yaml cut to C12 npz=8 and 2 steps in
    #     float64, on the card and on the CPU
    raw = read_yaml("earthlike_c24.yaml")
    raw.update(nx_tile=12, nz=8, minutes=15, precision=64)
    raw["diagnostics_config"]["output_format"] = DIAGNOSTICS_FORMAT
    f64 = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        r = json.loads(json.dumps(raw))
        r["diagnostics_config"]["path"] = os.path.join(out_root, f"f64_{tag}", "output")
        r["performance_config"]["experiment_name"] = os.path.join(out_root, f"f64_{tag}", "exp")
        drv = Driver(DriverConfig.from_dict(r), device=d)
        start = drv.state
        drv.step_all()
        drv.cleanup()
        f64[tag] = dict(driver=drv, start=start)
    card, cpu = f64["card"]["driver"], f64["cpu"]["driver"]
    f64_scales = step_f64_scales(SimpleNamespace(state=f64["cpu"]["start"], grid=cpu.grid_data,
                                                 core=cpu.dycore), constants)
    check_step_f64("driver, earthlike_c24.yaml's config, 2 steps", card.state, cpu.state,
                   field_scales=f64_scales, setup="C12 npz=8 f64", split="")
    check_physics_f64("driver, earthlike_c24.yaml's config: its surface state",
                      surface_fields(card.physics.surface_state),
                      surface_fields(cpu.physics.surface_state), setup="C12 npz=8 f64")

    def diagnostic_fields(drv_):
        extras = drv_._physics_extras()
        return {nm: getattr(drv_.state, nm, None) if getattr(drv_.state, nm, None) is not None
                else extras[nm] for nm in drv_.config.diagnostics_config.names}

    check_physics_f64("driver, earthlike_c24.yaml's config: the diagnostics' fields",
                      diagnostic_fields(card), diagnostic_fields(cpu), setup="C12 npz=8 f64")
    recs = [diagnostics_records(f64[t]["driver"].config.diagnostics_config.path)
            for t in ("card", "cpu")]
    off = {}
    for nm, y in recs[1].items():
        x = recs[0][nm]
        ulp = torch.from_numpy(np.spacing(np.maximum(np.abs(x.numpy()), np.abs(y.numpy()))))
        off[nm] = int(((x.double() - y.double()).abs() > ulp).sum())
    log(f"[check] C12 npz=8 f64 driver, earthlike_c24.yaml's config: stored float32 records, "
        f"points more than one float32 ulp apart, card vs CPU: {off}; restarts not checked on "
        f"the card (h5py is not installed there)")
    if any(off.values()):
        raise AssertionError(f"[driver f64] stored diagnostics differ: {off}")
    del f64, card, cpu, drv, recs
    log(f"[wall] section 7 (the driver) took {time.perf_counter() - t_drv:.1f} s")

    # ------------------------------------------------------------------
    # 8. what queue 1 item 3 added: tropicalcyclone_c128.yaml as written
    #    (this slice's main path), external grids, Fortran restarts, the
    #    golden savepoints, debug_checks, pair_debug, savepoint
    #    initialization and the GEOS wrapper
    # ------------------------------------------------------------------
    tc_launches = item3_phases(dev, counters, zero_counters, out_root, configs)

    # ------------------------------------------------------------------
    # 9. what queue 1 items 7 and 8 added: the comm configs, and the mesh
    #    on one NCCL rank and on three gloo ranks sharing the card
    # ------------------------------------------------------------------
    mesh_launches = comm_mesh_phases(dev, counters, zero_counters, out_root, configs, c192,
                                     n=n, npz=npz)
    del c192

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
                   "dycore_step_held_suarez": hs_launches[name],
                   "driver_baroclinic_c192": drv_launches[name],
                   "driver_tropicalcyclone_c128": tc_launches[name],
                   "driver_baroclinic_c192_mesh_1_rank": mesh_launches["mesh_1_rank"][name]}
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
    sys.exit(mesh_rank_main(sys.argv) if "--mesh-rank" in sys.argv else main())
