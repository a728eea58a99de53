"""Whole runs of a cell on the CPU at C12 (the harness's look for a card
skipped): the result line's keys, the control and each fault the cells can
have coming out not correct under the cells' own limits, and the command
refusing to run without a card."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import control, harness, registry, run
from benchmark.tests import faults

SMALL = {"nx_tile": 12, "nz": 8}
CELL = "tc_c128"


def run_small(cell=CELL, seed=11):
    return harness.run_cell(cell, seed, 0.0, False, device="cpu", shrink=SMALL)


@pytest.fixture
def check_steps(monkeypatch):
    """The step number each run's check step lands on."""
    steps = []
    take = harness.take_check_step

    def recorded(driver, outs, **kw):
        take(driver, outs, **kw)
        steps.append(driver._step_count)
    monkeypatch.setattr(harness, "take_check_step", recorded)
    return steps


def test_result_line_has_the_contract_keys(check_steps):
    out = run_small()
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"sypd", "peak_mem_gb", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
    assert check_steps == [6]


def test_traced_run_reads_per_layer_metrics_on_cpu(check_steps):
    out = harness.run_cell(CELL, 12, 0.0, True, device="cpu", shrink=SMALL)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert out["correct"] is True, out["checks"]
    # the CPU has no device trace: only the host's metrics are read
    assert set(out["metrics"]) == {"step_mfu", "host_issue_ms"}
    # the check step comes before the traced stretch: the warm-up and a
    # window of one step end at step 2, so it is step 6, the first
    # diagnostics step after the window, as in a run without the trace
    assert check_steps == [6]


@pytest.fixture
def broken(monkeypatch):
    """Patch the program's step with one of the faults a run can have
    (``faults.py``)."""
    return lambda fault: faults.plant(fault, monkeypatch.setattr)


@pytest.mark.parametrize("fault", ["state unchanged", "half the shards left out",
                                   "exchange left out", "answer altered"])
def test_fault_is_not_correct(broken, fault):
    broken(fault)
    out = run_small(seed=13)
    assert out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("variant", ["bf16", "bf16_state"])
def test_control_is_not_correct(variant):
    """Each control in the program's place fails the cell's limits (here on
    the CPU at C12; PERF.md gives their readings on the card at the cells'
    sizes)."""
    cell = registry.workload(CELL)
    cfg = registry.config(cell["config"])
    raw = registry.merge(registry.driver_dict(cell, cfg), SMALL)
    recipes = cfg.get("inputs", []) + cell.get("inputs", [])
    from benchmark.reference import model as ref_model

    from benchmark import check

    mt = ref_model.metric_terms(raw)
    pre = check.tensors_of(harness.apply_inputs(
        ref_model.initial_state(raw, mt, "cpu", torch.float32), recipes, 13, 3))
    prog = harness.Outputs(init=pre, warm_time=0.0, warm={}, sfc_warm=None, pre=pre)
    numbers = control.control_numbers(raw, recipes, 13, "cpu", 3, prog, ["ps", "ua", "va"],
                                      variant=variant)
    correct, checks = check.judge(numbers, cell["limits"])
    assert correct is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in checks.values())


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and buf.getvalue() == ""
