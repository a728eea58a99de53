"""Readings for the check's limits: the program's numbers over many seeds and
the controls' over a few, on the card at a cell's own size, in one process.

Run on the card from the root of a checkout::

    python3 -m benchmark.calibrate --workload c192_dry --seeds 12 --control 3 \\
        --first-seed 4000000001 --steps 12

For each seed it builds the seeded initial state (the driver and its grid
are built once), takes the warm-up step as a run does, drives the rest of
``--steps`` steps, takes the check step as a run does and prints the
check's numbers as one JSON line; for the first ``--control`` seeds it also
prints both controls' numbers (``control.py``) from the same inputs, and
the witness: the program's check step and the float32 reference's against
the reference in float64. ``--warm-only`` stops each seed after the
warm-up step and reads the set-up's and the warm-up step's numbers alone.
The limits in the cell's file are set from these readings (``PERF.md``
gives them); the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time

import torch

from . import check, control, harness, program, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    ap.add_argument("--steps", type=int, default=6,
                    help="steps before the check step, the warm-up step first")
    ap.add_argument("--warm-only", action="store_true",
                    help="compare the set-up and the warm-up step only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cell = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    raw = registry.driver_dict(cell, cfg)
    run_dir = harness.RUN_ROOT / f"calibrate_{args.workload}"
    shutil.rmtree(run_dir, ignore_errors=True)
    raw = registry.merge(raw, {"minutes": 0, "hours": 0, "days": 0,
                               "seconds": int(raw["dt_atmos"]),
                               "diagnostics_config": {"path": str(run_dir / "diagnostics")}})
    recipes = cfg.get("inputs", []) + cell.get("inputs", [])
    program.build_kernels()
    driver = program.build_driver(raw, device)
    h = driver.metric_terms.spec.n_halo
    base = check.to_host(check.tensors_of(driver.state))
    names = list(driver.config.diagnostics_config.names)
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        driver.state = dataclasses.replace(
            driver.state, **{k: v.to(device) for k, v in base.items()})
        driver._step_count = 0
        driver.time_seconds = 0.0
        if driver.physics is not None and driver.physics._surface is not None:
            driver.physics.surface_state = driver.physics._surface.init(
                tuple(driver.state.ps.shape), driver.state.ps.dtype, device=device)
        driver.state = harness.apply_inputs(driver.state, recipes, seed, h)
        outs = harness.warm_up(driver, device)
        if args.warm_only:
            outs.grid = check.to_host(check.tensors_of(driver.grid_data))
        else:
            for _ in range(args.steps - 1):
                driver.step_all()
            harness.take_check_step(driver, outs)
        ref = harness.reference_outputs(raw, recipes, seed, device, outs.dtype, h, outs, names)
        numbers = harness.compare(outs, ref, h)
        print(json.dumps({"seed": seed, "side": "program", "step": driver._step_count,
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
        if i < args.control:
            for variant in ("bf16", "bf16_state"):
                ctl = control.control_numbers(raw, recipes, seed, device, h, outs, names,
                                              variant=variant, ref=ref)
                print(json.dumps({"seed": seed, "side": f"control_{variant}", "numbers": ctl}),
                      flush=True)
            if not args.warm_only:
                wit = control.witness_gaps(raw, device, h, outs,
                                           {"program": (outs.post, outs.sfc_post),
                                            "reference": (ref.post, ref.sfc_post)})
                print(json.dumps({"seed": seed, "side": "witness_float64", "fields": wit}),
                      flush=True)
        del ref, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
