"""One run of one cell: set-up, warm-up, the timed window, the check step,
the traced stretch, the check against the reference, and the result line.

:func:`run_cell` takes the device and a ``shrink`` of the driver dict as
arguments so that the tests drive a whole run on the CPU at a small size;
``run.py``, the command, refuses to run without the card.

With ``ranks`` (``ranks.Ranks``: a cell on N cards, one process a card) the
run is one rank's: the driver takes ``mesh_config`` and holds the rank's
block of the shards, every rank takes the same steps (rank 0's clock ends
the window), every rank profiles the same steps, and the reference steps
each rank's block on the same ranks; the check's numbers are combined over
the ranks. Rank 0's result is the run's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, inputs, program, registry, trace
from . import workmodel as wm
from .reference import model as ref_model
from .reference.fv3ref.parallel import mesh as ref_mesh

RUN_ROOT = registry.RUN_ROOT
#: the host ranges whose device time the per-layer metrics read, innermost
#: wins (the program's stage ranges)
STAGES = ("HaloExchange", "DynCore", "TracerAdvection", "Remapping")
#: a seed recipe's generator seed: the run's seed and the recipe's place
_SEED_STRIDE = 1_000_003


def log(msg: str) -> None:
    # one write a line, so that the lines of ranks sharing standard error
    # do not run into each other
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def apply_inputs(state, recipes: List[dict], seed: int, n_halo: int,
                 block: Optional[tuple] = None):
    """The state with the cell's seeded inputs applied in order, each recipe
    from its own seed of the draws on the state's device. ``block``: ``(lo,
    hi, n_shards)`` when the state holds those shards of the cube (a
    rank's), which then get the numbers the whole cube's draw gives them."""
    draws = inputs.Draws(state.pt.device, block)
    for k, r in enumerate(recipes):
        draws.seed((int(seed) * _SEED_STRIDE + k) % (2 ** 63))
        state = registry.input_recipe(r["recipe"]).apply(state, r.get("params", {}), draws,
                                                         n_halo)
    return state


def _block(mesh) -> Optional[tuple]:
    """``(lo, hi, n_shards)`` of a mesh, or None without one."""
    return None if mesh is None else (mesh.lo, mesh.hi, mesh.n_shards)


def _surface(driver):
    """The physics' surface state, or None."""
    return None if driver.physics is None else driver.physics.surface_state


def host_state(driver):
    """The program's state and surface state (None without one), on the
    host."""
    sfc = _surface(driver)
    return (check.to_host(check.tensors_of(driver.state)),
            check.to_host(check.tensors_of(sfc)) if sfc is not None else None)


@dataclasses.dataclass
class Outputs:
    """What one side hands the check, on the host: the seeded initial state
    the set-up derived, the warm-up step's model time and the state and
    surface state after it; the check step's state before it, its model
    time, the state and surface state after it and the record it wrote; the
    grid. The check step's fields are None where it was not taken."""

    init: Dict[str, torch.Tensor]
    warm_time: float
    warm: Dict[str, torch.Tensor]
    sfc_warm: Optional[Dict[str, torch.Tensor]]
    grid: Optional[Dict[str, torch.Tensor]] = None
    pre: Optional[Dict[str, torch.Tensor]] = None
    sfc_pre: Optional[Dict[str, torch.Tensor]] = None
    time_seconds: float = 0.0
    post: Optional[Dict[str, torch.Tensor]] = None
    sfc_post: Optional[Dict[str, torch.Tensor]] = None
    record: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    dtype: torch.dtype = torch.float32


def warm_up(driver, device, ranks=None) -> Outputs:
    """The warm-up step through ``Driver.step_all``, with the seeded initial
    state before it and the state after it kept for the check."""
    init = check.to_host(check.tensors_of(driver.state))
    warm_time = float(driver.time_seconds)
    drive(driver, device, 0.0, max_steps=1, ranks=ranks)
    warm, sfc_warm = host_state(driver)
    return Outputs(init=init, warm_time=warm_time, warm=warm, sfc_warm=sfc_warm,
                   dtype=driver.state.pt.dtype)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    issue_seconds: float = 0.0
    subcycles: List[List[int]] = dataclasses.field(default_factory=list)


def drive(driver, device, seconds: float, max_steps: Optional[int] = None,
          ranks=None) -> Window:
    """``Driver.step_all`` (one step per call) until ``seconds`` have passed;
    every step the window began is completed and counted. With ``ranks``,
    the ranks start together, and after each step (``step_all`` ends with a
    synchronize) rank 0's clock decides for every rank whether to stop."""
    w = Window()
    issue0 = driver.timer.times.get("mainloop", 0.0)
    _sync(device)
    if ranks is not None:
        ranks.barrier()
    t0 = time.perf_counter()
    while True:
        driver.step_all()
        w.steps += 1
        w.subcycles.append(list(driver.dycore.tracer_subcycles))
        stop = time.perf_counter() - t0 >= seconds or bool(max_steps and w.steps >= max_steps)
        if ranks is not None:
            stop = ranks.agree(stop)
        if stop:
            break
    _sync(device)
    w.seconds = time.perf_counter() - t0
    w.issue_seconds = driver.timer.times.get("mainloop", 0.0) - issue0
    return w


class _PhysicsSpan:
    """Stands in for ``Driver.physics`` while the physics is timed: each call
    between two synchronizes, its host wall time kept."""

    def __init__(self, physics, device, walls: List[float]):
        self._inner = physics
        self._device = device
        self._walls = walls

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, *args, **kwargs):
        _sync(self._device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.physics"):
            out = self._inner(*args, **kwargs)
        _sync(self._device)
        self._walls.append(time.perf_counter() - t0)
        return out


@contextlib.contextmanager
def physics_span(driver, device, walls: List[float]):
    inner = driver.physics
    driver.physics = _PhysicsSpan(inner, device, walls)
    try:
        yield
    finally:
        driver.physics = inner


def profile_steps(driver, device, n: int):
    """``n`` whole steps under ``torch.profiler`` with the benchmark's spans
    around each step and its end-of-step actions. Returns the device
    operations, the stretch's host wall seconds and each step's tracer
    sub-cycles."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    end_of_step = driver._end_of_step_actions

    def spanned_end_of_step():
        with torch.profiler.record_function("bench.end_of_step"):
            end_of_step()

    subcycles = []
    driver._end_of_step_actions = spanned_end_of_step
    try:
        with profile(activities=activities) as prof:
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function("bench.step"):
                    driver.step_all()
                subcycles.append(list(driver.dycore.tracer_subcycles))
            _sync(device)
            wall = time.perf_counter() - t0
    finally:
        del driver._end_of_step_actions
    return trace.device_ops(prof.events()), wall, subcycles


def read_diagnostics(path: str, names: List[str]) -> Dict[str, torch.Tensor]:
    """The last time record of each of ``names`` in a zarr v2 store written
    by the driver (uncompressed, one chunk per time index)."""
    out = {}
    for name in names:
        d = Path(path) / name
        meta = json.loads((d / ".zarray").read_text())
        it = meta["shape"][0] - 1
        shape = tuple(meta["chunks"][1:])
        raw = (d / ".".join([str(it)] + ["0"] * len(shape))).read_bytes()
        out[name] = torch.from_numpy(np.frombuffer(raw, dtype=meta["dtype"]).reshape(shape)
                                     .astype(np.float32))
    return out


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader reads."""

    ops: List[trace.DeviceOp]
    profiled_steps: int
    stretch_seconds: float
    profiled_subcycles: List[List[int]]
    window: Window
    step_config: wm.StepConfig
    shapes: wm.Shapes
    physics_walls: List[float]

    def step_bound(self, subcycles) -> float:
        return sum(wm.step_bound(self.step_config, self.shapes, subcycles).values())

    def stage_seconds(self) -> Dict[str, float]:
        return trace.attribute(self.ops, STAGES)


def _context(driver, window: Window, h: int, **traced) -> MetricContext:
    st = driver.state
    fields = dict(ops=[], profiled_steps=0, stretch_seconds=0.0, profiled_subcycles=[],
                  physics_walls=[])
    fields.update(traced)
    return MetricContext(window=window, step_config=wm.StepConfig.of(driver.config.dycore_config),
                         shapes=wm.Shapes.of_state(tuple(st.delp.shape), st.q.shape[1], h,
                                                   st.delp.element_size()), **fields)


def cell_dict(cell_name: str, shrink: Optional[dict] = None, n_ranks: int = 1) -> dict:
    """The driver dict a run of the cell builds: on ``n_ranks`` > 1 ranks
    with ``mesh_config``, a layout whose shards do not divide over them
    refused."""
    cell = registry.workload(cell_name)
    raw = registry.driver_dict(cell, registry.config(cell["config"]))
    if shrink:
        raw = registry.merge(raw, shrink)
    if n_ranks == 1:
        return raw
    ly, lx = raw.get("layout", (1, 1))
    if (6 * ly * lx) % n_ranks:
        raise ValueError(f"layout [{ly}, {lx}] has {6 * ly * lx} shards, which do not divide "
                         f"over {n_ranks} ranks: choose a layout with 6*ly*lx a multiple of "
                         f"{n_ranks}")
    return registry.merge(raw, {"mesh_config": {"enabled": True, "n_devices": n_ranks}})


def run_cell(cell_name: str, seed: int, seconds: float, trace_run: bool, device="cuda",
             shrink: Optional[dict] = None, t_start: Optional[float] = None,
             spec: Optional[dict] = None, ranks=None) -> dict:
    """One run of the cell; returns the result line's dict (``checks`` last).

    ``shrink``: keys merged into the driver dict (the tests' small sizes);
    ``ranks``: this process's rank of a run on several (``ranks.Ranks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = registry.workload(cell_name)
    cfg = registry.config(cell["config"])
    raw = cell_dict(cell_name, shrink, 1 if ranks is None else ranks.world)
    run_dir = RUN_ROOT / cell_name
    if ranks is None or ranks.rank == 0:
        shutil.rmtree(run_dir, ignore_errors=True)
    if ranks is not None:
        # no rank enters the directory before rank 0 has emptied it
        ranks.barrier()
    run_dir.mkdir(parents=True, exist_ok=True)
    # one step per call of step_all; the diagnostics and the driver's perf
    # report land in the run's directory
    raw = registry.merge(raw, {"minutes": 0, "hours": 0, "days": 0,
                               "seconds": int(raw["dt_atmos"]),
                               "diagnostics_config": {"path": str(run_dir / "diagnostics")}})
    recipes = cfg.get("inputs", []) + cell.get("inputs", [])
    limits = dict(cell["limits"])
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        result = _run(cell_name, cell, raw, recipes, seed, seconds, trace_run, device, t_start,
                      limits, spec, ranks)
    finally:
        os.chdir(cwd)
    return result


def _run(cell_name, cell, raw, recipes, seed, seconds, trace_run, device, t_start, limits,
         spec, ranks) -> dict:
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        program.build_kernels()
    # --- set-up: the driver as the command line builds it, the seeded
    #     inputs, one warm-up step; the states before and after it are kept
    #     for the check
    driver = program.build_driver(raw, device)
    h = driver.metric_terms.spec.n_halo
    driver.state = apply_inputs(driver.state, recipes, seed, h, _block(driver.mesh))
    # the peak of the set-up before the warm-up step: the driver's build and
    # the seeded draws (on a rank, each a whole cube's array)
    inputs_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    outs = warm_up(driver, device, ranks)
    setup_s = time.perf_counter() - t_start
    tag = "" if ranks is None else f" rank {ranks.rank}"
    log(f"[bench] {cell_name} seed {seed}{tag}: set-up {setup_s:.3f} s, peak before the warm-up "
        f"step {inputs_peak / 1e9:.4f} GB")

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1 if ranks is None else ranks.world}

    # --- the window; a step that raises (a safety check, a launch) ends the
    #     run as not correct, with the checks unread; on several ranks it
    #     ends the rank, and the launcher the run
    try:
        window = drive(driver, device, seconds, ranks=ranks)
    except Exception:
        if ranks is not None:
            raise
        log(traceback.format_exc())
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device) if cuda else 0)
        return {"correct": False, "attempted": driver._step_count, "failed": 1, "metrics": {},
                "device": dev_info, "checks": check.judge({}, limits)[1]}
    dt = float(raw["dt_atmos"])
    sypd = window.steps * dt / window.seconds / 365.0
    log(f"[bench]{tag} window: {window.steps} steps in {window.seconds:.3f} s, "
        f"{1e3 * window.seconds / window.steps:.3f} ms a step, sypd {sypd:.6f}")
    metrics: Dict[str, dict] = {}
    spec = spec if spec is not None else registry.benchmark_spec()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # on several cards, the fullest card's
    peaks = [int(peak)] if ranks is None else ranks.gather(int(peak))
    peak = max(peaks)
    dev_info["memory_peak_bytes"] = peak

    # --- the check step: the next diagnostics step after the window, in
    #     both kinds of run, kept on the host for the reference
    failed = 0
    try:
        take_check_step(driver, outs, ranks=ranks)
    except Exception:
        if ranks is not None:
            raise
        log(traceback.format_exc())
        failed = 1

    breakdown = nccl_s = None
    if trace_run and not failed:
        # the traced steps start right after a diagnostics step, so that the
        # same steps of the cycle are profiled in every run
        freq = driver.config.diagnostics_config.output_frequency
        walls: List[float] = []
        if driver.physics is not None and cell.get("physics_span_steps", 0):
            with physics_span(driver, device, walls):
                drive(driver, device, 0.0, max_steps=cell["physics_span_steps"])
        while driver._step_count % freq:
            driver.step_all()
        ops, stretch, prof_sub = profile_steps(driver, device, cell["profile_steps"])
        # on a mesh NCCL's kernels wait for their peers: read by no metric
        ops, nccl_s = trace.split_nccl(ops)
        if nccl_s:
            log(f"[bench]{tag} NCCL kernels {1e3 * nccl_s / cell['profile_steps']:.3f} ms a "
                f"profiled step, waits included")
        if cuda and (ranks is None or ranks.rank == 0):
            log(f"[bench] card: {power_limit()}")
        ctx = _context(driver, window, h, ops=ops, profiled_steps=cell["profile_steps"],
                       stretch_seconds=stretch, profiled_subcycles=prof_sub, physics_walls=walls)
        for m in registry.metrics_of(cell_name, True, spec):
            v = registry.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        # on several cards the per-layer metrics, the busy time and the
        # traced window are rank 0's
        dev_info.update(busy_s=trace.busy_seconds(ops), window_s=stretch)
        breakdown = {"device_ops": [list(x) for x in trace.top_ops(ops)],
                     "idle_gaps": [list(x) for x in trace.idle_gaps(ops)[:10]]}
        del ops, ctx
    if not trace_run:
        # the three of BENCHMARK.json; one that a later cell adds is read by
        # its own reader, from the window
        e2e = {"sypd": sypd, "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        for m in registry.metrics_of(cell_name, False, spec):
            v = (e2e[m["name"]] if m["name"] in e2e else
                 registry.metric_reader(m["name"]).read(_context(driver, window, h)))
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # --- the check: the program's set-up, warm-up step and check step
    #     against the reference, once the program's state is freed
    driver.state = None
    del driver
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    numbers = {}
    ref_peak = 0
    if not failed:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        try:
            numbers = reference_gaps(raw, recipes, seed, device, h, outs, ranks)
        except Exception:
            if ranks is not None:
                raise
            log(traceback.format_exc())
            failed = 1
        if cuda:
            ref_peak = int(torch.cuda.max_memory_allocated(device))
            log(f"[check]{tag} reference peak {ref_peak / 1e9:.4f} GB")
    correct, checks = check.judge(numbers, limits)
    if ranks is None or ranks.rank == 0:
        for name, c in checks.items():
            log(f"[check] {name} {c['value']} limit {c['limit']}")
    out = {"correct": correct and not failed, "attempted": window.steps, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if ranks is not None:
        # each card's peaks (the set-up's before the warm-up step, the run's,
        # the reference's), and traced, its busy time and its NCCL kernels'
        rows = ranks.gather({"memory_peak_bytes": peaks[ranks.rank],
                             "inputs_peak_bytes": inputs_peak,
                             "reference_peak_bytes": ref_peak,
                             "busy_s": dev_info.get("busy_s"),
                             "nccl_s": nccl_s})
        out["ranks"] = [dict(rank=r, **row) for r, row in enumerate(rows)]
    out["checks"] = checks
    return out


def take_check_step(driver, outs: Outputs, ranks=None) -> None:
    """Step on to the step before the next diagnostics step, then take that
    step through ``Driver.step_all``; keep in ``outs`` the program's state
    before and after it (and its surface state), its model time, the record
    it wrote, and the program's grid, all on the host. With ``ranks``: the
    rank's block of each, the record (rank 0 wrote the whole cube's) read
    once it is written."""
    freq = driver.config.diagnostics_config.output_frequency
    while (driver._step_count + 1) % freq:
        driver.step_all()
    outs.pre, outs.sfc_pre = host_state(driver)
    outs.time_seconds = float(driver.time_seconds)
    driver.step_all()
    outs.post, outs.sfc_post = host_state(driver)
    names = list(driver.config.diagnostics_config.names)
    if ranks is not None:
        ranks.barrier()
    outs.record = (read_diagnostics(driver.config.diagnostics_config.path, names)
                   if names else {})
    if driver.mesh is not None:
        lo, hi = driver.mesh.lo, driver.mesh.hi
        outs.record = {k: v[lo:hi] for k, v in outs.record.items()}
    outs.grid = check.to_host(check.tensors_of(driver.grid_data))


def reference_outputs(raw, recipes, seed, device, dtype, h, prog: Outputs,
                      diag_names: List[str], round_to=None, start: bool = True,
                      ranks=None) -> Outputs:
    """What the program hands the check, made by the reference in ``dtype``
    on ``device`` from the same inputs as ``prog``'s: the seed, the warm-up
    step's model time, and the state before the check step where ``prog``
    took one. ``round_to``: the state handed to each step is rounded through
    that dtype first. ``start`` false skips the grid, the initial state and
    the warm-up step. ``ranks``: this rank's block of each, the reference
    stepped on the same ranks."""

    def rounded(state):
        if round_to is None:
            return state
        return dataclasses.replace(state, **{
            f.name: getattr(state, f.name).to(round_to).to(dtype)
            for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), torch.Tensor)})

    def surface(ref):
        if ref.physics is None or ref.physics.surface_state is None:
            return None
        return check.tensors_of(ref.physics.surface_state)

    t0 = time.perf_counter()
    mt = ref_model.metric_terms(raw)
    mesh = None if ranks is None else ref_mesh.cube_mesh(mt.lon_agrid.shape[0], device)
    ref = ref_model.build(raw, device, dtype, mt=mt, mesh=mesh)
    outs = Outputs(init={}, warm_time=prog.warm_time, warm={}, sfc_warm=None,
                   time_seconds=prog.time_seconds, dtype=dtype)
    if start:
        outs.grid = check.tensors_of(ref.grid)
        t1 = time.perf_counter()
        shards = None if mesh is None else range(mesh.lo, mesh.hi)
        state = apply_inputs(ref_model.initial_state(raw, mt, device, dtype, shards), recipes,
                             seed, h, _block(mesh))
        outs.init = check.tensors_of(state)
        t2 = time.perf_counter()
        # the warm-up step from the reference's own initial state
        outs.warm = check.tensors_of(ref.step(rounded(state), prog.warm_time))
        outs.sfc_warm = surface(ref)
        _sync(device)
        log(f"[check] reference {dtype}: grid {t1 - t0:.3f} s, initial state {t2 - t1:.3f} s, "
            f"warm-up step {time.perf_counter() - t2:.3f} s")
        del state
    if prog.pre is not None:
        # the check step from the program's state before it
        state = ref_model.state_from_tensors(prog.pre, device, dtype)
        if ref.physics is not None and prog.sfc_pre is not None:
            template = ref.physics._surface.init(state.ps.shape, dtype, device=device)
            sfc_pre = {k: v.to(round_to or dtype) for k, v in prog.sfc_pre.items()}
            ref.physics.surface_state = ref_model.fill_dataclass(template, sfc_pre, device, dtype)
        t1 = time.perf_counter()
        outs.post = check.tensors_of(ref.step(rounded(state), prog.time_seconds))
        _sync(device)
        log(f"[check] reference {dtype}: check step {time.perf_counter() - t1:.3f} s")
        del state
        outs.sfc_post = surface(ref)
        extras = {}
        if outs.sfc_post is not None:
            sf = ref.physics.surface_state
            extras["precipitation"] = sf.precip
            if ref.physics._surface is not None:
                extras.update(ref.physics._surface.diagnostics(sf))
        for k in diag_names:
            f = outs.post.get(k, extras.get(k))
            if f is not None:
                outs.record[k] = f[..., h:-h, h:-h]
    return outs


def _step_gaps(prefix: str, prog, sfc_prog, ref, sfc_ref, h, gap, rms, missing) -> Dict:
    """``<prefix>.<field>`` (largest gap) and ``<prefix>_rms.<field>`` of a
    stepped state and its surface state (``.surface.<field>``)."""
    out = check.field_gaps(prog, ref, h, f"{prefix}.", gap, missing)
    out.update(check.field_gaps(prog, ref, h, f"{prefix}_rms.", rms, missing))
    if sfc_ref is not None:
        out.update(check.field_gaps(sfc_prog or {}, sfc_ref, h, f"{prefix}.surface.", gap,
                                    missing))
        out.update(check.field_gaps(sfc_prog or {}, sfc_ref, h, f"{prefix}_rms.surface.", rms,
                                    missing))
    return out


def compare(prog: Outputs, ref: Outputs, h, ranks=None) -> Dict[str, float]:
    """The numbers of ``check.py``: ``prog`` held against ``ref`` (the
    reference's outputs from the same inputs). With ``ranks`` both hold the
    rank's block, and each gap's parts are combined over the ranks first."""
    if ranks is None:
        gap, rms, missing = check.field_gap, check.field_rms_gap, math.inf
    else:
        gap, rms, missing = check.gap_parts, check.rms_parts, check.MISSING
    # "grid_gap/<field>" and "init_gap/<field>" fold into their worst
    gaps = {}
    if prog.grid is not None and ref.grid is not None:
        gaps.update(check.field_gaps(prog.grid, ref.grid, None, "grid_gap/", gap, missing))
    if ref.init:
        gaps.update(check.field_gaps(prog.init, ref.init, None, "init_gap/", gap, missing))
        gaps.update(_step_gaps("warm", prog.warm, prog.sfc_warm, ref.warm, ref.sfc_warm, h, gap,
                               rms, missing))
    if ref.post is not None:
        gaps.update(_step_gaps("step", prog.post, prog.sfc_post, ref.post, ref.sfc_post, h, gap,
                               rms, missing))
        for k, v in prog.record.items():
            r = ref.record.get(k)
            gaps[f"diag.{k}"] = missing if r is None else gap(v, r, None)
    if ranks is not None:
        gaps = {k: check.finish(p) for k, p in ranks.combine(gaps).items()}
    numbers, folded = {}, {}
    for k, v in gaps.items():
        whole, sep, field = k.partition("/")
        if sep:
            folded.setdefault(whole, {})[field] = v
        else:
            numbers[k] = v
    for whole, fields in folded.items():
        numbers[whole], _ = check.worst(fields)
    return numbers


def reference_gaps(raw, recipes, seed, device, h, outs: Outputs, ranks=None) -> Dict[str, float]:
    """The numbers of ``check.py`` for the program's ``outs``, the
    reference built in the program's dtype (with ``ranks``, this rank's
    block of it, stepped on the same ranks)."""
    t0 = time.perf_counter()
    numbers = compare(outs, reference_outputs(raw, recipes, seed, device, outs.dtype, h, outs,
                                              list(outs.record), ranks=ranks), h, ranks)
    worst = sorted(((k, v) for k, v in numbers.items() if k.startswith(("warm", "step"))),
                   key=lambda kv: -kv[1])[:6]
    log(f"[check] reference: {time.perf_counter() - t0:.3f} s; worst: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst))
    return numbers


def jax_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX, its libraries or the
    JAX package, compared whole (the port's name begins with the JAX
    package's)."""
    banned = {"jax", "jaxlib", "flax", "pace_tpu"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & banned)

