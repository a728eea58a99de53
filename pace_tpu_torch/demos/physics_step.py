"""Dycore steps followed by the physics: the port of ``bench.py``'s
``BENCH_PHYSICS=1`` path.

Each step is ``DynamicalCore.step_dynamics`` in ``bench.py``'s configuration
(``demos/dycore_step``, with its :data:`~.dycore_step.STABLE_DAMPING`),
then ``Physics(grid, ("GFS_microphysics", "GFS_PBL"), 200.0, fv_sg_adj=0.0)``:
the GFDL microphysics and the EDMF PBL at their default configurations.
The metric is ``bench.py``'s, grid-point updates per second over the timed
steps, each ended by a device synchronise; the physics call's own wall time
is reported beside the whole step's.

The baroclinic-wave state is dry. :func:`moist_tracers` seeds the tracer
block from a seed with numpy (vapor between 0.3 and 1.1 of saturation at
each point, saturation capped at :data:`QSAT_MAX`, small amounts of the five
condensates, the other tracers in [1e-4, 1.1e-3]), so that condensation,
evaporation, the ice processes and sedimentation all act; the tests give the
same arrays to ``pace_tpu``.

Run::

    python -m pace_tpu_torch.demos.physics_step                # C192, on the card
    python -m pace_tpu_torch.demos.physics_step --n 24 --npz 8 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .. import constants
from ..constants import TRACER_NAMES
from ..dtypes import to_tensor
from ..models.fv3.state import DycoreState
from ..models.shield.microphysics import saturation_mixing_ratio
from ..models.shield.physics import Physics
from . import dycore_step as ddemo

#: bench.py's physics schemes
SCHEMES = ("GFS_microphysics", "GFS_PBL")

#: the cap [kg/kg] on the saturation mixing ratio that the vapor is seeded
#: from: in the top layers, near 200 Pa, the fit's saturation vapor pressure
#: exceeds the pressure itself and its mixing ratio is no bound at all
QSAT_MAX = 0.02

#: the upper bound [kg/kg] of each condensate's seeded mixing ratio
CONDENSATE_MAX = {"qliquid": 2e-4, "qice": 1e-4, "qrain": 1e-4, "qsnow": 1e-4,
                  "qgraupel": 5e-5}


def moist_tracers(state: DycoreState, seed: int = 0) -> np.ndarray:
    """A float64 tracer block of ``state.q``'s shape from ``seed``: vapor
    uniform in [0.3, 1.1] of the saturation mixing ratio at each point's dry
    temperature ``pt * pkz`` and mid-layer pressure (at most QSAT_MAX), each
    condensate uniform in [0, CONDENSATE_MAX], the other tracers uniform in
    [1e-4, 1.1e-3]."""
    f64 = dict(device="cpu", dtype=torch.float64)
    t = state.pt.to(**f64) * state.pkz.to(**f64)
    pe = state.pe.to(**f64)
    qsat = np.minimum(
        saturation_mixing_ratio(t, 0.5 * (pe[..., 1:, :, :] + pe[..., :-1, :, :])).numpy(),
        QSAT_MAX)
    rng = np.random.default_rng(seed)
    q = np.empty(tuple(state.q.shape))
    for i, name in enumerate(TRACER_NAMES):
        if name == "qvapor":
            q[:, i] = qsat * rng.uniform(0.3, 1.1, qsat.shape)
        elif name in CONDENSATE_MAX:
            q[:, i] = rng.uniform(0.0, CONDENSATE_MAX[name], qsat.shape)
        else:
            q[:, i] = rng.uniform(1e-4, 1.1e-3, qsat.shape)
    return q


def water_budget(before, after, precip, delp, area, n_halo: int):
    """The water budget of a microphysics call on the compute domain, summed
    in float64: ``before`` and ``after`` the six water species, ``precip``
    the surface precipitation [kg/m^2]. Returns ``(|M1 + P - M0| / M0, M0,
    P)``, M the species' mass sum(q delp) area / g [kg] and P the
    precipitated mass sum(precip area) [kg]."""
    i = (..., slice(n_halo, -n_halo), slice(n_halo, -n_halo))
    a = area[i].double()
    dp = delp[i].double()

    def mass(species):
        q = sum(s[i].double() for s in species)
        return float(((q * dp).sum(dim=-3) * a).sum()) / constants.GRAV

    m0, m1 = mass(before), mass(after)
    p = float((precip[i].double() * a).sum())
    return abs(m1 + p - m0) / m0, m0, p


@dataclasses.dataclass
class PhysicsCase(ddemo.StepCase):
    """A dycore step case with the physics that follows each step."""

    physics: Physics = None


def build_case(n: int = 192, npz: int = 79, device="cuda", dtype=torch.float32, seed: int = 0,
               schemes=SCHEMES, physics_kw: dict = None, **overrides) -> PhysicsCase:
    """:func:`~.dycore_step.build_case` (``overrides`` change the dycore
    configuration) with the tracer block of :func:`moist_tracers` and
    ``Physics(grid, schemes, TIMESTEP, fv_sg_adj=0.0, **physics_kw)``."""
    case = ddemo.build_case(n, npz, device, dtype, **overrides)
    case.state.q = to_tensor(moist_tracers(case.state, seed), case.state.q.device, dtype)
    physics = Physics(case.grid, schemes, ddemo.TIMESTEP, fv_sg_adj=0.0, **(physics_kw or {}))
    return PhysicsCase(**{f.name: getattr(case, f.name) for f in dataclasses.fields(case)},
                       physics=physics)


def run(n: int = 192, npz: int = 79, warm: int = 1, steps: int = 2, device="cuda",
        dtype=torch.float32, case: PhysicsCase = None, **overrides) -> dict:
    """Take ``warm`` untimed and ``steps`` timed steps (the dycore step, then
    the physics) from the case's state (``case`` or a new one). Returns the
    case with its advanced state, the wall ms of each timed step and of its
    physics call, their means, the metric and the tracer sub-cycles."""
    case = case or build_case(n, npz, device, dtype, **overrides)
    dev = case.state.u.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step_ms, physics_ms, subcycles = [], [], []
    for r in range(warm + steps):
        sync()
        t0 = time.perf_counter()
        state = case.core.step_dynamics(case.state)
        sync()
        t1 = time.perf_counter()
        case.state = case.physics(state)
        sync()
        t2 = time.perf_counter()
        if r >= warm:
            step_ms.append(1e3 * (t2 - t0))
            physics_ms.append(1e3 * (t2 - t1))
        subcycles.append(list(case.core.tracer_subcycles))
    ms = sum(step_ms) / len(step_ms)
    points = 6 * case.n * case.n * case.core.config.npz
    return {
        "case": case, "step_ms": step_ms, "ms_per_step": ms, "physics_ms": physics_ms,
        "physics_ms_per_step": sum(physics_ms) / len(physics_ms),
        "gridpoints_per_s": points / (ms / 1e3), "tracer_subcycles": subcycles,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=79)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0, help="seed of the tracer block")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    case = build_case(args.n, args.npz, args.device, dtype, seed=args.seed)
    out = run(warm=args.warm, steps=args.steps, case=case)
    print(json.dumps({
        "metric": f"C{args.n}_dycore_physics_gridpoints_per_s_per_chip",
        "value": round(out["gridpoints_per_s"], 1),
        "unit": "gridpoints/s",
    }))


if __name__ == "__main__":
    main()
