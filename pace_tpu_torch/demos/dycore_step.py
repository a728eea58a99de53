"""Whole dycore steps of the C192 benchmark configuration: the port of
``bench.py``'s single-device path.

Builds the cubed-sphere grid and the Jablonowski-Williamson (2006)
baroclinic-wave state with the perturbation on, then takes
``DynamicalCore.step_dynamics`` steps in ``bench.py``'s configuration:
nonhydrostatic, ``timestep = 200 s``, ``k_split = 7``, ``n_split = 8``, hord
6 (tracers 8), kord 9 / -9, ``nord = 3`` with vorticity damping, ``d_con =
1``, ``vtdm4 = 0.06``, ``rf_fast`` with ``tau = 10 s``, ``fill``, ``n_sponge
= 48`` and dynamic tracer sub-cycling. The metric is ``bench.py``'s:
grid-point updates per second, ``6 N^2 npz steps / wall``, over the timed
steps, each ended by a device synchronise.

From this state ``bench.py``'s divergence damping diverges (ROADMAP queue
3): at the top two levels the del-2 boost (``d2_bg_k1 = 0.2``, ``d2_bg_k2 =
0.1``) is added to the del-(2 nord + 2) damping and the sum exceeds the
explicit scheme's limit within the first step, in ``pace_tpu`` as in the
port; without the boost, ``d4_bg = 0.15`` still grows a mode at the bottom
level next to the edge between tiles 0 and 2 at C192 in float32 within the
second step. :func:`build_case`, and so :func:`run` and the command line,
therefore apply :data:`STABLE_DAMPING` (no boost, ``d4_bg = 0.12``) unless
the caller overrides those fields: the step metric is not measured at
``bench.py``'s damping coefficients. The change is to coefficients only,
not to one operation or kernel launch of the step.

Run::

    python -m pace_tpu_torch.demos.dycore_step                 # C192, on the card
    python -m pace_tpu_torch.demos.dycore_step --n 24 --npz 8 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..dtypes import check_dtype, resolve_device
from ..grid.generation import GridSpec, MetricTerms
from ..grid.grid_data import GridData
from ..models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
from ..models.fv3.state import DycoreState
from ..parallel.halo import HaloExchanger

#: the dycore step [s]
TIMESTEP = 200.0

#: the damping coefficients build_case applies over bench.py's, with which
#: the step stays bounded from the baroclinic-wave state (module docstring)
STABLE_DAMPING = dict(d2_bg_k1=0.0, d2_bg_k2=0.0, d4_bg=0.12)


def bench_config(npz: int = 79, **overrides) -> DynamicalCoreConfig:
    """``bench.py``'s configuration (``bench.py:64-97``), with ``overrides``."""
    kw = dict(
        npz=npz, k_split=7, n_split=8, hydrostatic=False, nord=3, d4_bg=0.15, d2_bg=0.0,
        d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5, do_vort_damp=True, vtdm4=0.06, d_con=1.0,
        rf_cutoff=3000.0, rf_fast=True, tau=10.0, fill=True, n_sponge=48, hord_mt=6,
        hord_vt=6, hord_tm=6, hord_dp=6, hord_tr=8, kord_mt=9, kord_tm=-9, kord_tr=9,
        kord_wz=9, tracer_dynamic_subcycle=True,
    )
    kw.update(overrides)
    return DynamicalCoreConfig(**kw)


@dataclasses.dataclass
class StepCase:
    """Grid, halo, dycore and state of one run."""

    n: int
    grid: GridData
    halo: HaloExchanger
    core: DynamicalCore
    state: DycoreState


def build_case(n: int = 192, npz: int = 79, device="cuda", dtype=torch.float32,
               **overrides) -> StepCase:
    """Generate the C``n`` grid and the baroclinic-wave state on ``device``
    and the dycore in the benchmark's configuration with
    :data:`STABLE_DAMPING` (``overrides`` change it, e.g. ``k_split=2``, or
    ``d2_bg_k1=0.2, d2_bg_k2=0.1, d4_bg=0.15`` for ``bench.py``'s
    damping)."""
    dev = resolve_device(device)
    check_dtype(dtype)
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device=dev, dtype=dtype)
    state = DycoreState.from_baroclinic_init(mt, perturbation=True, device=dev, dtype=dtype)
    config = bench_config(npz, **{**STABLE_DAMPING, **overrides})
    core = DynamicalCore(grid, mt.halo, config, timestep=TIMESTEP)
    return StepCase(n=n, grid=grid, halo=mt.halo, core=core, state=state)


def run(n: int = 192, npz: int = 79, warm: int = 1, steps: int = 2, device="cuda",
        dtype=torch.float32, case: StepCase = None, **overrides) -> dict:
    """Take ``warm`` untimed and ``steps`` timed steps from the case's state
    (``case`` or a new one). Returns the case with its advanced state, the
    wall ms of each timed step, their mean, the metric, and the tracer
    sub-cycles and (with ``consv_te > 0``; read after the step's timing)
    the energy fixer's increments [K] of each outer step, one list per step
    taken."""
    case = case or build_case(n, npz, device, dtype, **overrides)
    dev = case.state.u.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step_ms, subcycles, energy_dT = [], [], []
    for r in range(warm + steps):
        sync()
        t0 = time.perf_counter()
        case.state = case.core.step_dynamics(case.state)
        sync()
        if r >= warm:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        subcycles.append(list(case.core.tracer_subcycles))
        energy_dT.append([float(t) for t in case.core.energy_fix_dT])
    ms = sum(step_ms) / len(step_ms)
    points = 6 * case.n * case.n * case.core.config.npz
    return {
        "case": case, "step_ms": step_ms, "ms_per_step": ms,
        "gridpoints_per_s": points / (ms / 1e3),
        "tracer_subcycles": subcycles, "energy_fix_dT": energy_dT,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=79)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    args = ap.parse_args()
    out = run(args.n, args.npz, args.warm, args.steps, args.device,
              torch.float64 if args.f64 else torch.float32)
    print(json.dumps({
        "metric": f"C{args.n}_dycore_gridpoints_per_s_per_chip",
        "value": round(out["gridpoints_per_s"], 1),
        "unit": "gridpoints/s",
    }))


if __name__ == "__main__":
    main()
