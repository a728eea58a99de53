"""Follow the divergence-damping mode of the dycore benchmark configuration
substep by substep, in ``pace_tpu`` or in its PyTorch port.

Both implementations start from the Jablonowski-Williamson baroclinic-wave
state with the perturbation on and take ``DynamicalCore.step_dynamics``
steps in ``bench.py``'s configuration (``pace_tpu_torch.demos.dycore_step.
bench_config``) with the chosen damping coefficients:

- ``bench``: ``bench.py``'s (``d2_bg_k1 = 0.2``, ``d2_bg_k2 = 0.1``,
  ``d4_bg = 0.15``);
- ``boost-off``: no del-2 boost at the top two levels, ``d4_bg = 0.15``;
- ``stable``: no boost, ``d4_bg = 0.12``.

Each acoustic substep prints one line, the same in both implementations:
its number, max|u| on the compute domain's u points and where it is
(tile, level, row, column of the padded array), and the largest change of u
over the substep and where it is. ``pace_tpu`` prints from inside its jitted
step through ``jax.debug.callback``; the port runs on ``--device``.

Run::

    python tools/torch_damping_mode.py --impl torch --n 192 --npz 79 --device cuda
    JAX_PLATFORMS=cpu python tools/torch_damping_mode.py --impl jax --n 192 --npz 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DAMPING = {
    "bench": dict(d2_bg_k1=0.2, d2_bg_k2=0.1, d4_bg=0.15),
    "boost-off": dict(d2_bg_k1=0.0, d2_bg_k2=0.0, d4_bg=0.15),
    "stable": dict(d2_bg_k1=0.0, d2_bg_k2=0.0, d4_bg=0.12),
}
H = 3


class Printer:
    """Counts substeps and prints one line for each."""

    def __init__(self, label):
        self.label, self.count = label, 0

    def __call__(self, umax, uloc, dumax, duloc):
        self.count += 1
        print(f"{self.label} sub {self.count} max|u| {float(umax):.6e} at {list(map(int, uloc))}"
              f" max|du| {float(dumax):.6e} at {list(map(int, duloc))}", flush=True)


def _where(flat, shape):
    """(tile, level, row, column) of the padded array from a flat index of
    its compute-domain slice of ``shape``."""
    idx = np.unravel_index(int(flat), shape)
    return (idx[0], idx[1], idx[2] + H, idx[3] + H)


def run_torch(args, damping, printer):
    import torch

    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.models.fv3 import acoustics

    dtype = torch.float64 if args.f64 else torch.float32
    case = ddemo.build_case(args.n, args.npz, device=args.device, dtype=dtype, **damping)
    orig = acoustics._one_substep

    def traced(u, *a, **k):
        res = orig(u, *a, **k)
        new, old = res[0][..., H:-H, H:-H], u[..., H:-H, H:-H]
        du = (new - old).abs()
        printer(new.abs().max(), _where(new.abs().argmax(), new.shape),
                du.max(), _where(du.argmax(), du.shape))
        return res

    acoustics._one_substep = traced
    for s in range(args.steps):
        t0 = time.perf_counter()
        try:
            case.state = case.core.step_dynamics(case.state)
        except (RuntimeError, ValueError) as e:
            print(f"{printer.label} stopped in step {s} after substep {printer.count}: {e}")
            return
        u = case.state.u[..., H:-H, H:-H]
        print(f"{printer.label} step {s} max|u| {float(u.abs().max()):.6e}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def run_jax(args, damping, printer):
    import jax

    jax.config.update("jax_enable_x64", args.f64)
    import jax.numpy as jnp

    from pace_tpu.grid.generation import GridSpec, MetricTerms
    from pace_tpu.grid.grid_data import GridData
    from pace_tpu.models.fv3 import acoustics
    from pace_tpu.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
    from pace_tpu.models.fv3.state import DycoreState

    # bench.py's configuration with the chosen damping, as the port builds it
    from pace_tpu_torch.demos.dycore_step import bench_config

    cfg = bench_config(args.npz, **damping)
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    dtype = jnp.float64 if args.f64 else jnp.float32
    mt = MetricTerms.generate(GridSpec(n_tile=args.n, npz=args.npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, dtype=dtype)
    state = DycoreState.from_baroclinic_init(mt, perturbation=True, dtype=dtype)
    orig = acoustics._one_substep

    def traced(u, *a, **k):
        res = orig(u, *a, **k)
        new, old = res[0][..., H:-H, H:-H], u[..., H:-H, H:-H]
        du = jnp.abs(new - old)
        shape = new.shape

        def emit(umax, uflat, dumax, duflat):
            printer(umax, _where(uflat, shape), dumax, _where(duflat, shape))

        jax.debug.callback(emit, jnp.abs(new).max(), jnp.abs(new).argmax(), du.max(),
                           du.argmax(), ordered=True)
        return res

    acoustics._one_substep = traced
    core = DynamicalCore(grid, mt.halo, DynamicalCoreConfig(**cfg_kw), timestep=200.0)
    for s in range(args.steps):
        t0 = time.perf_counter()
        state = core.step_dynamics(state)
        u = np.asarray(state.u)[..., H:-H, H:-H]
        print(f"{printer.label} step {s} max|u| {np.abs(u).max():.6e}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not np.isfinite(u).all():
            return


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("torch", "jax"), required=True)
    ap.add_argument("--n", type=int, default=192, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=79)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--damping", choices=tuple(DAMPING), default="boost-off")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    ap.add_argument("--device", default="cuda", help="the port's device")
    args = ap.parse_args()

    label = f"{args.impl} C{args.n} npz={args.npz} {'f64' if args.f64 else 'f32'} {args.damping}"
    printer = Printer(label)
    (run_jax if args.impl == "jax" else run_torch)(args, DAMPING[args.damping], printer)


if __name__ == "__main__":
    main()
