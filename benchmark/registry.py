"""Everything the harness runs, found by name.

- ``configs/<config>.json``: a configuration (its source, what was cut, the
  sizes assumed, and the driver's yaml as a dict under ``driver``);
- ``workloads/<cell>.json``: a cell (its configuration, its overrides of the
  driver dict, its seeded inputs, its profile lengths and its limits);
- ``inputs/<recipe>.py``: a seed recipe, ``apply(state, params, draws, n_halo)``;
- ``metrics/<metric>.py``: a per-layer metric reader, ``read(ctx)``.

A later cell, configuration, recipe or metric is a new file here and a new
entry in ``BENCHMARK.json``; no file that is already here changes.
"""

from __future__ import annotations

import copy
import importlib
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: where a run writes: the diagnostics store and the driver's perf report,
#: inside the checkout, emptied at the start of each run of the cell
RUN_ROOT = ROOT / "build" / "benchmark"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(kind: str, name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _read_json(HERE / "configs" / f"{_check_name('config', name)}.json")


def workload(name: str) -> dict:
    return _read_json(HERE / "workloads" / f"{_check_name('workload', name)}.json")


def workload_names() -> List[str]:
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def input_recipe(name: str):
    return importlib.import_module(f"benchmark.inputs.{_check_name('input', name)}")


def metric_reader(name: str):
    """The reader module of per-layer metric ``name``; a dotted metric name
    (``dispatch_ms.train``) is the file ``dispatch_ms__train.py``."""
    return importlib.import_module(
        f"benchmark.metrics.{_check_name('metric', name).replace('.', '__')}")


def benchmark_spec() -> dict:
    return _read_json(ROOT / "BENCHMARK.json")


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` merged in, key by key into nested dicts."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def driver_dict(cell: dict, cfg: dict) -> Dict:
    """The driver configuration a cell runs: its configuration's yaml with
    the cell's overrides."""
    return merge(cfg["driver"], cell.get("driver_overrides", {}))


def metrics_of(cell_name: str, trace: bool, spec: dict = None) -> List[dict]:
    """The metrics a run of ``cell_name`` prints: the end-to-end ones
    (``trace`` false) or the per-layer ones (``trace`` true) whose
    ``workloads`` list names the cell or which have none."""
    spec = spec if spec is not None else benchmark_spec()
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]
