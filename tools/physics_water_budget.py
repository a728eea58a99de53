"""The water budget of one microphysics call, in ``pace_tpu`` or in its
PyTorch port.

From the Jablonowski-Williamson baroclinic-wave state with the tracer block
of ``pace_tpu_torch.demos.physics_step.moist_tracers``, one call of
``microphysics_step`` as ``bench.py``'s physics makes it (the default
``MicrophysicsConfig``, dt = 200 s, two sub-steps) on the fields of
``dycore_to_physics``. Prints the budget of ``physics_step.water_budget``:
the change of the six water species' mass plus the surface precipitation,
over the water mass, summed in float64 over the compute domain (the gate of
``chip_smoke.py``'s ``[step physics]``).

Run::

    JAX_PLATFORMS=cpu python tools/physics_water_budget.py --impl jax --n 24 --npz 79
    python tools/physics_water_budget.py --impl torch --n 24 --npz 79               # the card
    python tools/physics_water_budget.py --impl torch --n 24 --npz 79 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPECIES = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel")


def budget_jax(n, npz, f64, seed):
    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pace_tpu.grid.generation import GridSpec, MetricTerms
    from pace_tpu.grid.grid_data import GridData
    from pace_tpu.models.fv3.state import DycoreState
    from pace_tpu.models.shield import microphysics, physics
    from pace_tpu_torch.demos import physics_step
    from pace_tpu_torch.models.fv3.state import DycoreState as TDycoreState

    dtype = jnp.float64 if f64 else jnp.float32
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, dtype=dtype)
    state = DycoreState.from_baroclinic_init(mt, perturbation=True, dtype=dtype)
    arrays = {f.name: None if getattr(state, f.name) is None
              else np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}
    tstate = TDycoreState.from_numpy(arrays, device="cpu", dtype=torch.float64)
    q = physics_step.moist_tracers(tstate, seed)
    state = dataclasses.replace(state, q=jnp.asarray(q, dtype=dtype))
    phy = physics.dycore_to_physics(state)
    before = [getattr(phy, s) for s in SPECIES]
    out = microphysics.microphysics_step(*before, phy.pt, phy.p_mid, phy.delp, 200.0)

    def t(a):
        return torch.from_numpy(np.array(a))

    return physics_step.water_budget([t(a) for a in before], [t(a) for a in out[:6]],
                                     t(out[7]), t(phy.delp), t(grid.area), grid.n_halo)


def budget_torch(n, npz, f64, seed, device):
    import torch

    from pace_tpu_torch.demos import physics_step
    from pace_tpu_torch.models.shield import microphysics, physics

    case = physics_step.build_case(n, npz, device, torch.float64 if f64 else torch.float32,
                                   seed=seed)
    phy = physics.dycore_to_physics(case.state)
    before = [getattr(phy, s) for s in SPECIES]
    out = microphysics.microphysics_step(*before, phy.pt, phy.p_mid, phy.delp, 200.0)
    return physics_step.water_budget(before, out[:6], out[7], phy.delp, case.grid.area,
                                     case.grid.n_halo)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--npz", type=int, default=79)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    ap.add_argument("--device", default="cuda", help="the port's device (cpu for the plain "
                    "PyTorch path)")
    args = ap.parse_args()
    if args.impl == "jax":
        rel, m0, p = budget_jax(args.n, args.npz, args.f64, args.seed)
    else:
        rel, m0, p = budget_torch(args.n, args.npz, args.f64, args.seed, args.device)
    print(f"{args.impl} C{args.n} npz={args.npz} {'f64' if args.f64 else 'f32'}: water mass "
          f"{m0:.9e} kg, precipitated {p:.9e} kg, budget |dM + P| / M = {rel:.3e}")


if __name__ == "__main__":
    main()
