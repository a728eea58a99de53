"""BENCHMARK.json and the files the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness, registry

SPEC = registry.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"]
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s", "sypd", "peak_mem_gb"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    data = registry.config(cfg["name"])
    assert Path(cfg["file"]) == Path("benchmark/configs") / f"{cfg['name']}.json"
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert set(data["why_reduced"]) == set(cfg["reduced"])
    assert data["driver"]["nx_tile"] > 0
    for r in data.get("inputs", []):
        assert callable(registry.input_recipe(r["recipe"]).apply)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_found_by_name(cell):
    data = registry.workload(cell["name"])
    assert data["config"] == cell["config"]
    assert cell["chips"] in (1, 4)
    if cell["chips"] > 1:
        # the cell's layout splits over its ranks (harness.cell_dict)
        harness.cell_dict(cell["name"], n_ranks=cell["chips"])
    limits = data["limits"]
    assert limits["grid_gap"] == 0.0 and limits["init_gap"] == 0.0
    assert any(k.startswith("step.") for k in limits) and any(k.startswith("diag.") for k in limits)
    assert all(isinstance(v, float) and v >= 0 for v in limits.values())
    # each limit lies between its two readings, 0 only for an exact comparison
    for k, (lower, upper) in data["readings"].items():
        assert lower <= limits[k] < upper and upper >= 3 * lower, k
        assert (limits[k] == 0) == (lower == 0), k
    assert set(data["readings"]) == set(limits)
    raw = registry.driver_dict(data, registry.config(data["config"]))
    assert raw["diagnostics_config"]["output_format"] == "zarr"
    for r in data.get("inputs", []):
        assert callable(registry.input_recipe(r["recipe"]).apply)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    assert {"setup_s", "sypd"} <= {m["name"] for m in registry.metrics_of(cell["name"], False)}
    assert registry.metrics_of(cell["name"], True)


def test_few_cells_ask_for_four_chips():
    """At most a quarter of the cells, rounded down, and at least one may
    take four chips."""
    four = [w["name"] for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4), four


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(registry.metric_reader(metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_unknown_names_are_refused():
    for bad in ("../x", "a b", "x/y", ""):
        with pytest.raises(ValueError):
            registry.workload(bad)


def test_merge_is_key_by_key():
    base = {"a": {"b": 1, "c": 2}, "d": [1]}
    assert registry.merge(base, {"a": {"c": 3}, "d": [2]}) == {"a": {"b": 1, "c": 3}, "d": [2]}
    assert base == {"a": {"b": 1, "c": 2}, "d": [1]}


def test_new_workload_file_runs_without_edits(tmp_path, monkeypatch):
    """A cell added as one new file (and its BENCHMARK.json entry) runs
    through the unchanged harness: the TC with diagnostics every step, at
    C12 on the CPU."""
    for sub in ("configs", "workloads"):
        (tmp_path / sub).mkdir()
        for f in (registry.HERE / sub).glob("*.json"):
            (tmp_path / sub / f.name).write_text(f.read_text())
    cell = registry.workload("tc_c128")
    cell.update(name="tc_c128_output_every_step",
                driver_overrides={"diagnostics_config": {"output_frequency": 1}})
    (tmp_path / "workloads" / "tc_c128_output_every_step.json").write_text(json.dumps(cell))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "tc_c128_output_every_step", "config": "tropicalcyclone_c128",
                              "traffic": "output_every_step", "chips": 1, "why": "test"})
    monkeypatch.setattr(registry, "HERE", tmp_path)
    assert "tc_c128_output_every_step" in registry.workload_names()
    out = harness.run_cell("tc_c128_output_every_step", 7, 0.0, False, device="cpu",
                           shrink={"nx_tile": 12, "nz": 8}, spec=spec)
    assert out["correct"] is True
    assert out["metrics"]["sypd"]["value"] > 0
