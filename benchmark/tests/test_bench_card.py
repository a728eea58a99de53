"""On the card: one short run of each cell through the command, its last
line holding a correct result with the contract's keys.

Run there with ``python3 -m pytest benchmark -m bench_card``."""

import json
import subprocess
import sys

import pytest

from benchmark import registry


@pytest.mark.bench_card
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                        "2147483659", "--seconds", "3", "--trace", "0"],
                       cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
