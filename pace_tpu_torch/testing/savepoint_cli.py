"""Savepoint workflow CLI: generate reference data, calibrate thresholds,
validate a run.

Port of ``pace_tpu.testing.savepoint_cli`` (reference role: the savepoint
suite with its ``--data_path``/``--threshold_path``/``--calibrate_thresholds``
options and a committed thresholds file). The run is on the card unless
``--device cpu`` asks for the CPU.

Usage::

    python -m pace_tpu_torch.testing.savepoint_cli generate  cfg.yaml -o ref.npz
    python -m pace_tpu_torch.testing.savepoint_cli calibrate cfg.yaml -r ref.npz \
        -o thresholds.yaml --trials 10 --factor 10
    python -m pace_tpu_torch.testing.savepoint_cli validate  cfg.yaml -r ref.npz \
        -t thresholds.yaml [--steps N] [--device cpu]

``generate`` records every stage checkpoint (FVDynamics/C_SW/D_SW/
Tracer2D1L/Remapping In/Out, and Physics In/Out with physics) of an
unperturbed run. ``calibrate`` replays N round-off-perturbed runs against
that data and writes per-stage per-variable absolute+relative thresholds =
factor * max observed divergence. ``validate`` re-runs and asserts every
checkpoint is inside the thresholds on the compute domain of each array
(the ghost cells hold values that no stage computes and no consumer reads,
and the kernels leave other ones there than the plain versions), exiting
nonzero on failure. The recordings and thresholds are ``pace_tpu``'s
formats, so ``tests/data/savepoints/`` validates the port.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..driver.config import DriverConfig
from ..dtypes import resolve_device
from ..models.fv3.dycore import DynamicalCore
from .checkpointer import (
    SavepointThresholds,
    SnapshotCheckpointer,
    ThresholdCalibrationCheckpointer,
    ValidationCheckpointer,
    ValidationError,
)
from .perturb import perturb


def _build(config: DriverConfig, device="cuda"):
    """Grid + initial state from a driver yaml (the savepoint runs use the
    driver's own construction path so data matches what the model sees)."""
    from ..grid.grid_data import GridData

    device = resolve_device(device)
    dtype = torch.float64 if config.precision == 64 else torch.float32
    mt = config.grid_config.get_metric_terms(
        config.nx_tile, config.nz, config.layout
    )
    grid = GridData.from_metric_terms(mt, device=device, dtype=dtype)
    state = config.initialization.get_dycore_state(mt, device, dtype)
    return mt, grid, state


def _run(config: DriverConfig, checkpointer, state, grid, mt, steps: int):
    core = DynamicalCore(
        grid, mt.halo, config.dycore_config, config.dt_atmos,
        checkpointer=checkpointer,
    )
    physics = None
    if config.physics_config.schemes and not config.dycore_only:
        # physics savepoints (Physics-In/Out) recorded in the same pass
        from ..models.shield.physics import Physics
        from ..models.shield.surface import SurfaceConfig
        from ..utils.registry import from_dict

        pc = config.physics_config
        physics = Physics(
            grid, pc.schemes, config.dt_atmos,
            fv_sg_adj=config.dycore_config.fv_sg_adj,
            surface_config=from_dict(SurfaceConfig, pc.surface or {}),
            halo=mt.halo, checkpointer=checkpointer,
        )
    t = 0.0
    for _ in range(steps):
        state = core.step_dynamics(state)
        if physics is not None:
            state = physics(state, t)
        t += config.dt_atmos
    return state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pace_tpu_torch.testing.savepoint_cli")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs (default: the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="record reference savepoint data")
    g.add_argument("config")
    g.add_argument("-o", "--output", required=True, help="output .npz path")
    g.add_argument("--steps", type=int, default=1)

    c = sub.add_parser("calibrate", help="derive thresholds from perturbed trials")
    c.add_argument("config")
    c.add_argument("-r", "--reference", required=True, help="reference .npz")
    c.add_argument("-o", "--output", required=True, help="thresholds yaml path")
    c.add_argument("--steps", type=int, default=1)
    c.add_argument("--trials", type=int, default=10)
    c.add_argument("--factor", type=float, default=10.0)
    c.add_argument("--magnitude", type=float, default=1.0e-13)

    v = sub.add_parser("validate", help="validate a run against savepoints")
    v.add_argument("config")
    v.add_argument("-r", "--reference", required=True, help="reference .npz")
    v.add_argument("-t", "--thresholds", required=True, help="thresholds yaml")
    v.add_argument("--steps", type=int, default=1)

    for sp in (g, c, v):
        sp.add_argument("--device", default=argparse.SUPPRESS, choices=("cuda", "cpu"),
                        help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    config = DriverConfig.from_yaml(args.config)
    mt, grid, state = _build(config, args.device)

    if args.cmd == "generate":
        snap = SnapshotCheckpointer()
        _run(config, snap, state, grid, mt, args.steps)
        snap.save(args.output)
        n = sum(len(h) for h in snap.data.values())
        print(f"wrote {len(snap.data)} stages ({n} checkpoints) to {args.output}")
        return 0

    reference = SnapshotCheckpointer.load(args.reference)

    if args.cmd == "calibrate":
        calib = ThresholdCalibrationCheckpointer(reference, factor=args.factor)
        for trial in range(args.trials):
            with calib.trial():
                _run(
                    config, calib,
                    perturb(state, magnitude=args.magnitude, seed=trial),
                    grid, mt, args.steps,
                )
            print(f"trial {trial + 1}/{args.trials} done", file=sys.stderr)
        calib.thresholds().to_yaml(args.output)
        print(f"wrote thresholds for {len(calib.thresholds().savepoints)} "
              f"stages to {args.output}")
        return 0

    # validate, on the compute domain of each array
    thresholds = SavepointThresholds.from_yaml(args.thresholds)
    chk = ValidationCheckpointer(reference, thresholds, n_halo=mt.halo.n_halo)
    try:
        with chk.trial():
            _run(config, chk, state, grid, mt, args.steps)
    except ValidationError as e:
        print(f"VALIDATION FAILED:\n{e}", file=sys.stderr)
        return 1
    n = sum(chk._hit.values())
    print(f"validation passed: {n} checkpoints within thresholds on the compute domain")
    return 0


if __name__ == "__main__":
    sys.exit(main())
