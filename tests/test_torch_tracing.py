"""The port's host syncs, clocks and ranges (``utils/ranges.py``,
``driver/performance.py``) on a C12 ``Driver`` on the CPU.

Every place the step waits on the card is a ``host_sync`` site: counted
always, and a ``HostSync.<site>`` range while a profiler records. The
Driver's clocks (``mainloop``, ``Physics``, ``Diagnostics``,
``SafetyChecks``) open ranges of their own names, and are the clocks the
perf report writes. Without a profiler no range is entered; with one, the
state is the same, bit for bit. ``scalar_like`` makes each 0-dim divisor
once per value, dtype and device: later steps make no ``scalar_like`` sync.
"""

import dataclasses

import pytest
import torch

from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.ops import stencil_utils
from pace_tpu_torch.utils import ranges

K_SPLIT = 2
NAMES = ["ps", "ua", "va"]


def c12_raw(path):
    """C12 nz=8, one step a ``step_all``, dynamic tracer sub-cycles, the
    dry adjustment as the only physics, ``NAMES`` written every 2 steps, the
    default safety checks."""
    return {
        "nx_tile": 12, "nz": 8, "dt_atmos": 225.0, "seconds": 225, "precision": 64,
        "dycore_only": True,
        "initialization": {"type": "baroclinic", "config": {"perturbation": True}},
        "dycore_config": {"k_split": K_SPLIT, "n_split": 2, "hydrostatic": True, "nord": 1,
                          "d4_bg": 0.15, "tracer_dynamic_subcycle": True,
                          "fv_sg_adj": 600.0},
        "diagnostics_config": {"path": str(path / "diag"), "output_frequency": 2,
                               "names": NAMES, "output_format": "zarr"},
        "performance_config": {"collect_performance": True,
                               "experiment_name": str(path / "c12")},
    }


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def driver(tmp_path, one_thread):
    return Driver(DriverConfig.from_dict(c12_raw(tmp_path)), device="cpu")


def syncs_of(fn):
    """``fn()``'s host syncs by site."""
    before = dict(ranges.SYNCS)
    fn()
    return {k: v - before.get(k, 0) for k, v in ranges.SYNCS.items() if v != before.get(k, 0)}


def test_step_counts_its_syncs(driver):
    first = syncs_of(driver.step_all)
    assert first["tracer_subcycles"] == K_SPLIT
    assert first["step_end"] == 1
    assert first["safety_checks"] == 1
    assert "diagnostics" not in first
    second = syncs_of(driver.step_all)
    # an output step: one copy to the host per field
    assert second["diagnostics"] == len(NAMES)
    # scalar_like copies a value to the device once a process: in the first
    # step at most, or in none where an earlier driver made the same values
    assert "scalar_like" not in second
    assert ({k: v for k, v in second.items() if k != "diagnostics"}
            == {k: v for k, v in first.items() if k != "scalar_like"})
    c = ranges.counters()
    assert c["syncs.step_end"] >= 2 and c["sync_seconds.step_end"] >= 0.0
    assert "launches.halo" in c and "launches.remap" in c


def test_later_steps_make_no_scalar_like_syncs(driver):
    driver.step_all()
    reused = []
    for _ in range(2):
        before = ranges.SCALAR_REUSES
        assert "scalar_like" not in syncs_of(driver.step_all)
        reused.append(ranges.SCALAR_REUSES - before)
    assert reused[0] == reused[1] > 0
    assert ranges.counters()["scalar_like.reused"] == ranges.SCALAR_REUSES


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scalar_like_gives_the_fresh_bits_once(dtype, monkeypatch):
    import math

    from pace_tpu_torch.constants import GRAV, P_REF

    monkeypatch.setattr(stencil_utils, "_SCALARS", {})
    like = torch.zeros(3, dtype=dtype)
    values = [6.0, 3.0, GRAV, P_REF, 225.0, 112.5, 0.1, math.log(750.0 / 3.0), 0.0, -0.0]
    before = dict(ranges.SYNCS), ranges.SCALAR_REUSES
    made = [stencil_utils.scalar_like(x, like) for x in values]
    for x, t in zip(values, made):
        fresh = torch.tensor(x, dtype=dtype, device=like.device)
        assert t.dtype == dtype and t.shape == () and _bits(t) == _bits(fresh), x
        assert stencil_utils.scalar_like(x, like) is t, x
    assert ranges.SYNCS["scalar_like"] - before[0].get("scalar_like", 0) == len(values)
    assert ranges.SCALAR_REUSES - before[1] == len(values)


def test_the_step_writes_no_cached_scalar(driver):
    driver.step_all()
    driver.step_all()
    assert stencil_utils._SCALARS
    for (hexval, dtype, device), t in stencil_utils._SCALARS.items():
        fresh = torch.tensor(float.fromhex(hexval), dtype=dtype, device=device)
        assert _bits(t) == _bits(fresh), hexval


def test_state_does_not_depend_on_the_cache(tmp_path, one_thread, monkeypatch):
    """Two steps with a fresh tensor at every call, as before the cache, and
    two with the tensors the cache already holds: the same bits."""

    class NeverKeeps(dict):
        def __setitem__(self, key, value):
            pass

    states = []
    for cached in (False, True):
        monkeypatch.setattr(stencil_utils, "_SCALARS", {} if cached else NeverKeeps())
        if cached:
            Driver(DriverConfig.from_dict(c12_raw(tmp_path / "fill")), device="cpu").step_all()
        d = Driver(DriverConfig.from_dict(c12_raw(tmp_path / str(cached))), device="cpu")
        before = dict(ranges.SYNCS)
        d.step_all()
        d.step_all()
        misses = ranges.SYNCS["scalar_like"] - before.get("scalar_like", 0)
        assert (misses == 0) if cached else (misses > 0)
        states.append(d.state)
    for f in dataclasses.fields(states[0]):
        a, b = getattr(states[0], f.name), getattr(states[1], f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def test_host_sync_counts_entries_and_seconds(monkeypatch):
    import collections
    import time

    monkeypatch.setattr(ranges, "SYNCS", collections.Counter())
    monkeypatch.setattr(ranges, "SYNC_SECONDS", collections.defaultdict(float))
    for _ in range(3):
        with ranges.host_sync("site"):
            time.sleep(0.01)
    assert ranges.SYNCS["site"] == 3
    assert ranges.SYNC_SECONDS["site"] >= 0.03
    assert ranges.counters()["syncs.site"] == 3


def test_profiled_step_holds_the_ranges(driver):
    from torch.profiler import ProfilerActivity, profile

    driver.step_all()
    before = dict(ranges.SYNCS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        driver.step_all()  # an output step
    names = [e.name for e in prof.events() if e.is_user_annotation]
    for site in ("tracer_subcycles", "step_end", "safety_checks", "diagnostics", "scalar_like"):
        assert names.count(f"HostSync.{site}") == ranges.SYNCS[site] - before.get(site, 0), site
    for clock in ("mainloop", "Physics", "Diagnostics", "SafetyChecks"):
        assert names.count(clock) == 1, clock
    for stage in ("FVDynamics", "DynCore", "TracerAdvection", "Remapping", "DryAdjustment"):
        assert stage in names, stage
    assert names.count("DynCore") == K_SPLIT


def test_no_profiler_enters_no_range(driver, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    driver.step_all()
    driver.step_all()


def test_perf_report_holds_the_clocks(driver):
    driver.step_all()
    driver.step_all()
    report = driver.performance.report(driver.config.dt_atmos)
    assert driver.timer is driver.performance.timer
    for clock in ("mainloop", "Physics", "Diagnostics", "SafetyChecks"):
        assert report["times"][clock] > 0.0, clock
    assert report["hits"]["mainloop"] == 2
    assert report["hits"]["Diagnostics"] == 1


def test_profiled_step_is_bit_identical(tmp_path, one_thread):
    from torch.profiler import ProfilerActivity, profile

    states = []
    for traced in (False, True):
        d = Driver(DriverConfig.from_dict(c12_raw(tmp_path / str(traced))), device="cpu")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                d.step_all()
        else:
            d.step_all()
        states.append(d.state)
    for f in dataclasses.fields(states[0]):
        a, b = getattr(states[0], f.name), getattr(states[1], f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def test_census_tool_finds_every_site_and_reads_host_ranges(driver):
    """``tools/torch_sync_census.py`` finds every ``host_sync`` block in the
    sources, and names the innermost host range open at a time of a CPU
    profile."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    path = Path(__file__).resolve().parents[1] / "tools" / "torch_sync_census.py"
    spec = importlib.util.spec_from_file_location("torch_sync_census", path)
    census = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(census)
    sites = {site for blocks in census.host_sync_blocks().values() for _a, _b, site in blocks}
    assert sites == {"scalar_like", "tracer_subcycles", "diagnostics", "safety_checks",
                     "step_end", "restart", "gather", "host_staged", "halo_record", "nan_check"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        driver.step_all()
    hr = census.host_ranges(prof.events())
    name, a, b = next(r for r in hr if r[0] == "HostSync.tracer_subcycles")
    outer = next(r for r in hr if r[0] == "TracerAdvection" and r[1] <= a and r[2] >= b)
    assert census.innermost_at(hr, [outer[1], (a + b) / 2]) == ["TracerAdvection", name]
