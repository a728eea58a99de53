"""The benchmark of ``pace_tpu_torch``: one run of one cell.

Run from the root of a checkout::

    python3 -m benchmark.run --workload c192_dry --seed 12345 --seconds 30 --trace 0

It builds the port's ``Driver`` from the cell's configuration, applies the
seeded inputs, warms up with one step, drives ``Driver.step_all`` for
``--seconds`` seconds, takes one more step, and checks the set-up, the
warm-up step and that step against the plain reference. With ``--trace 0`` the last line of standard output holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a ``torch.profiler`` trace of whole steps, and a ``breakdown``. The
numbers compared and their limits are the last lines of standard error and
the line's last key, ``checks``. Without a card it exits with 2 and prints
no result.

A cell whose ``chips`` is N > 1 runs as N ranks, one card each, through the
port's mesh (``ranks.py``); the result is rank 0's, printed here once every
rank has exited 0, and a rank that fails ends the run with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def _cache_dirs(root) -> None:
    """Fixed build and kernel cache directories inside the checkout, so that
    only the first run of a cell here builds (the program's own kernels
    build into ``build/kernels/`` beside them)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        path = root / "build" / "cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import registry

    spec = registry.benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the benchmark needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    _cache_dirs(registry.ROOT)

    from benchmark import harness

    try:
        if chips > 1:
            from benchmark import program, ranks

            harness.cell_dict(args.workload, n_ranks=chips)  # refuses a layout that does not split
            # the kernels once, before the ranks start
            program.build_kernels()
            result = ranks.launch(args.workload, args.seed, args.seconds, bool(args.trace), chips,
                                  t_start=T_START)
            if result is None:
                return 1
        else:
            result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                      device="cuda", t_start=T_START, spec=spec)
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.jax_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
