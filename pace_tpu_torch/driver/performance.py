"""Timers, performance collection, SYPD.

Port of ``pace_tpu.driver.performance`` (reference role: ``ndsl.performance``:
Timer/NullTimer with named clocks, a PerformanceCollector gathering mainloop
times and hit counts, ``get_sypd``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List

from ..utils.ranges import stage_range


class _Clock:
    """One run of a named clock, inside the stage range of the same name."""

    __slots__ = ("timer", "name", "_range")

    def __init__(self, timer: "Timer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self._range = stage_range(self.name)
        self._range.__enter__()
        self.timer.start(self.name)

    def __exit__(self, *exc):
        self.timer.stop(self.name)
        return self._range.__exit__(*exc)


class Timer:
    """Named wall clocks with hit counts. ``with timer.clock("mainloop"): ...``
    also opens the stage range ``"mainloop"``, so that a clock shows in a
    device trace."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.hits: Dict[str, int] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        dt = time.perf_counter() - self._starts.pop(name)
        self.times[name] = self.times.get(name, 0.0) + dt
        self.hits[name] = self.hits.get(name, 0) + 1

    def clock(self, name: str) -> _Clock:
        return _Clock(self, name)


class NullTimer(Timer):
    def start(self, name: str):
        pass

    def stop(self, name: str):
        pass


def get_sypd(mainloop_seconds_per_step: float, dt_atmos: float) -> float:
    """Simulated years per day (reference role: ndsl.performance.report.get_sypd)."""
    if mainloop_seconds_per_step <= 0:
        return float("inf")
    sim_per_wall = dt_atmos / mainloop_seconds_per_step
    return sim_per_wall * 86400.0 / (365.0 * 86400.0)


@dataclasses.dataclass
class PerformanceConfig:
    """``pace_tpu``'s fields and defaults."""

    collect_performance: bool = True
    collect_communication: bool = False
    experiment_name: str = "experiment"
    json_all_rank_threshold: int = 100
    #: dump a cProfile of the mainloop to {experiment_name}.prof
    collect_cprofile: bool = False
    #: write a TensorBoard-readable torch.profiler trace of the mainloop here
    profile_dir: str = ""
    #: attribute device time to the stages DynCore/TracerAdvection/Remapping
    #: (driver/stage_profile.py) by profiling one step after the first; the
    #: device times need a card (on the CPU the result is empty)
    collect_stage_times: bool = False

    def build(self) -> "PerformanceCollector":
        return PerformanceCollector(self)

    def build_profiler(self):
        """cProfile profiler or None."""
        if not self.collect_cprofile:
            return None
        import cProfile

        return cProfile.Profile()


class PerformanceCollector:
    def __init__(self, config: PerformanceConfig):
        self.config = config
        self.timer = Timer() if config.collect_performance else NullTimer()
        self.step_seconds: List[float] = []
        self.stage_device_seconds: Dict[str, float] = {}

    def record_step(self, seconds: float):
        self.step_seconds.append(seconds)

    def report(self, dt_atmos: float) -> dict:
        # step 0 (kernel builds, allocator warm-up) is excluded, as the
        # reference's performance scripts exclude it
        steps = self.step_seconds[1:] if len(self.step_seconds) > 1 else self.step_seconds
        mean = sum(steps) / len(steps) if steps else 0.0
        return {
            "experiment": self.config.experiment_name,
            "mainloop_mean_seconds": mean,
            "n_steps": len(self.step_seconds),
            "SYPD": get_sypd(mean, dt_atmos) if mean else None,
            "times": dict(self.timer.times),
            "hits": dict(self.timer.hits),
            # device seconds per stage for ONE step; empty unless
            # collect_stage_times ran on a card
            "stage_device_seconds": dict(self.stage_device_seconds),
        }

    def write_json(self, path: str, dt_atmos: float):
        with open(path, "w") as f:
            json.dump(self.report(dt_atmos), f, indent=2)
