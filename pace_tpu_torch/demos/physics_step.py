"""Dycore steps followed by the physics: the port of ``bench.py``'s
``BENCH_PHYSICS=1`` path.

Each step is ``DynamicalCore.step_dynamics`` in ``bench.py``'s configuration
(``demos/dycore_step``, with its :data:`~.dycore_step.STABLE_DAMPING`),
then a ``Physics`` call at the step's model time. Named physics sets:
``bench`` (:data:`SCHEMES`, ``bench.py``'s: the GFDL microphysics and the
EDMF PBL at their default configurations, ``fv_sg_adj=0``), ``earthlike``
(:data:`EARTHLIKE`, ``examples/configs/earthlike_c24.yaml``'s: gray
radiation, the PBL, deep and shallow SAS convection and the microphysics,
``fv_sg_adj=1800`` and the ``mixed`` surface, land equatorward of 55
degrees) and ``aquaplanet`` (:data:`AQUAPLANET`). The metric is ``bench.py``'s, grid-point updates
per second over the timed steps, each ended by a device synchronise; the
physics call's own wall time is reported beside the whole step's.

The baroclinic-wave state is dry. :func:`moist_tracers` seeds the tracer
block from a seed with numpy (vapor between 0.3 and 1.1 of saturation at
each point, saturation capped at :data:`QSAT_MAX`, small amounts of the five
condensates, the other tracers in [1e-4, 1.1e-3]), so that condensation,
evaporation, the ice processes and sedimentation all act; the tests give the
same arrays to ``pace_tpu``.

Run::

    python -m pace_tpu_torch.demos.physics_step                # C192, on the card
    python -m pace_tpu_torch.demos.physics_step --physics earthlike
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
from ..models.shield.microphysics import MicrophysicsConfig, saturation_mixing_ratio
from ..models.shield.physics import Physics
from ..models.shield.radiation import GrayRadiationConfig
from ..models.shield.surface import SurfaceConfig
from . import dycore_step as ddemo

#: bench.py's physics schemes
SCHEMES = ("GFS_microphysics", "GFS_PBL")

#: examples/configs/earthlike_c24.yaml's physics as build_case's keywords:
#: its schemes, dycore_config.fv_sg_adj and surface block, and the
#: microphysics with the dycore config's do_qa = False, as pace_tpu's driver
#: builds it
EARTHLIKE = dict(
    schemes=("gray_radiation", "GFS_PBL", "GFS_deep_convection", "GFS_shallow_convection",
             "GFS_microphysics"),
    fv_sg_adj=1800.0,
    surface_config=SurfaceConfig(type="mixed", land_lat_max=55.0, t_init=288.0, smc_init=0.25),
    physics_kw=dict(config=MicrophysicsConfig(do_qa=False)),
)

#: examples/configs/aquaplanet_c24.yaml's physics, the same way: gray
#: radiation with interactive vapor, the PBL, shallow SAS convection and the
#: microphysics over the sea-ice surface with a slab ocean
AQUAPLANET = dict(
    schemes=("gray_radiation", "GFS_PBL", "GFS_shallow_convection", "GFS_microphysics"),
    fv_sg_adj=1800.0,
    surface_config=SurfaceConfig(type="seaice", t_init=285.0, h_ice_init=0.0,
                                 seaice={"slab_ocean": True, "mixed_layer_depth": 30.0}),
    physics_kw=dict(config=MicrophysicsConfig(do_qa=False),
                    radiation_config=GrayRadiationConfig(interactive_vapor=True)),
)

#: the named physics sets of the command line
PHYSICS_SETS = {"bench": dict(schemes=SCHEMES), "earthlike": EARTHLIKE, "aquaplanet": AQUAPLANET}


def make_physics(grid, schemes=SCHEMES, physics_kw: dict = None, fv_sg_adj: float = 0.0,
                 surface_config: SurfaceConfig = None, timestep: float = ddemo.TIMESTEP):
    """``Physics(grid, schemes, timestep, fv_sg_adj=fv_sg_adj,
    surface_config=surface_config, **physics_kw)``: a physics set's
    keywords (:data:`EARTHLIKE`, ...) as a ``Physics``."""
    return Physics(grid, schemes, timestep, fv_sg_adj=fv_sg_adj, surface_config=surface_config,
                   **(physics_kw or {}))

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
    """A dycore step case with the physics that follows each step, and the
    model time [s] of the next step."""

    physics: Physics = None
    time_seconds: float = 0.0


def build_case(n: int = 192, npz: int = 79, device="cuda", dtype=torch.float32, seed: int = 0,
               schemes=SCHEMES, physics_kw: dict = None, fv_sg_adj: float = 0.0,
               surface_config: SurfaceConfig = None, time_seconds: float = 0.0,
               **overrides) -> PhysicsCase:
    """:func:`~.dycore_step.build_case` (``overrides`` change the dycore
    configuration) with the tracer block of :func:`moist_tracers` and the
    physics of :func:`make_physics`, starting at ``time_seconds``."""
    case = ddemo.build_case(n, npz, device, dtype, **overrides)
    case.state.q = to_tensor(moist_tracers(case.state, seed), case.state.q.device, dtype)
    physics = make_physics(case.grid, schemes, physics_kw, fv_sg_adj, surface_config)
    return PhysicsCase(**{f.name: getattr(case, f.name) for f in dataclasses.fields(case)},
                       physics=physics, time_seconds=time_seconds)


def run(n: int = 192, npz: int = 79, warm: int = 1, steps: int = 2, device="cuda",
        dtype=torch.float32, case: PhysicsCase = None, **overrides) -> dict:
    """Take ``warm`` untimed and ``steps`` timed steps (the dycore step, then
    the physics at the step's model time, which then advances by the
    timestep) from the case's state (``case`` or a new one). Returns the
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
        case.state = case.physics(state, case.time_seconds)
        sync()
        t2 = time.perf_counter()
        case.time_seconds += case.core.timestep
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
    ap.add_argument("--physics", choices=sorted(PHYSICS_SETS), default="bench",
                    help="the physics after each step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    case = build_case(args.n, args.npz, args.device, dtype, seed=args.seed,
                      **PHYSICS_SETS[args.physics])
    out = run(warm=args.warm, steps=args.steps, case=case)
    tag = "" if args.physics == "bench" else f"_{args.physics}"
    print(json.dumps({
        "metric": f"C{args.n}_dycore_physics{tag}_gridpoints_per_s_per_chip",
        "value": round(out["gridpoints_per_s"], 1),
        "unit": "gridpoints/s",
    }))


if __name__ == "__main__":
    main()
