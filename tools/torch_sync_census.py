#!/usr/bin/env python3
"""Where the port's host waits on the card, cell by cell of the benchmark.

Run from the repository root on a machine with a card::

    python3 tools/torch_sync_census.py [--cells c192_dry,tc_c128] [--seed N]
        [--window 6] [--out build/sync_census.json]

For each cell of ``benchmark/workloads/`` it builds the ``Driver`` as the
benchmark does (the cell's driver dict, its seeded inputs, one warm-up step)
and then:

1. **census**: one window step and the first diagnostics step under
   ``torch.cuda.set_sync_debug_mode("warn")``, each warning's Python stack
   kept; a warning is *covered* when a frame of its stack lies inside a
   ``with host_sync(...)`` block of ``pace_tpu_torch`` (found in the
   sources). The step's warnings are set beside its ``host_sync`` counts
   (``utils/ranges.SYNCS``), and the callers of each site are counted;
2. **window**: ``--window`` unprofiled steps, each site's syncs and host
   seconds a step (``SYNC_SECONDS``), the Driver's clocks a step, each
   step's wall time, the calls of ``scalar_like`` that reused a tensor
   (``scalar_like.reused``) and a digest of the state after the window;
3. **trace**: the cell's ``profile_steps`` steps after a diagnostics step
   under ``torch.profiler`` with the benchmark's ``bench.step`` and
   ``bench.end_of_step`` spans, as the benchmark's traced run takes them:
   the device time launched inside no program range; the idle time by the
   innermost host range open at each gap's start and, as the benchmark's
   breakdown gives it, at the launch that ends the gap; the idle time in
   gaps that begin inside a ``HostSync`` range, read from the host ranges
   and by the benchmark's ``sync_idle_ms`` reader, with the longest gaps on
   which the two disagree; the traced steps' wall
   time beside the window's (the cost of the profiler's ranges and
   activity tracing).

Prints one summary line per cell and writes everything to ``--out``.
"""

from __future__ import annotations

import argparse
import ast
import collections
import json
import os
import shutil
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness, program, registry, trace  # noqa: E402

PKG = ROOT / "pace_tpu_torch"


def host_sync_blocks():
    """``{file: [(first line, last line, site)]}`` of every ``with
    host_sync(...)`` block of the program."""
    out = collections.defaultdict(list)
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if not isinstance(call, ast.Call):
                    continue
                f = call.func
                name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
                if name == "host_sync" and call.args and isinstance(call.args[0], ast.Constant):
                    out[str(path)].append((node.lineno, node.end_lineno, call.args[0].value))
    return out


def _short(frame) -> str:
    return f"{Path(frame.filename).relative_to(ROOT)}:{frame.lineno} {frame.name}"


class Census:
    """The sync warnings of the steps run inside it."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.records = []

    def _site_of(self, frames):
        for fr in reversed(frames):
            for a, b, site in self.blocks.get(fr.filename, ()):
                if a <= fr.lineno <= b:
                    return site, fr
        return None, None

    def hook(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith("called a synchronizing CUDA operation"):
            return
        whole = traceback.extract_stack()[:-1]
        frames = [f for f in whole
                  if f.filename.startswith(str(ROOT)) and "/tools/" not in f.filename]
        site, at = self._site_of(frames)
        prog = [f for f in frames if f.filename.startswith(str(PKG))]
        inner = prog[-1] if prog else (frames[-1] if frames else None)
        # the caller of the function that holds the site's block
        caller = None
        if at is not None:
            k = next(i for i in range(len(prog) - 1, -1, -1) if prog[i] is at)
            caller = _short(prog[k - 1]) if k >= 1 else None
        # an uncovered warning keeps its whole stack's last frames
        stack = ([_short(f) for f in prog[-6:]] if site else
                 [f"{f.filename}:{f.lineno} {f.name}" for f in whole[-10:]])
        self.records.append({"site": site, "at": _short(inner) if inner else "?",
                             "caller": caller, "stack": stack})

    def run(self, fn, cuda=True):
        self.records = []
        old = warnings.showwarning
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.hook
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = old
        return self.records


def syncs_delta(before):
    from pace_tpu_torch.utils import ranges

    return ({k: v - before[0].get(k, 0) for k, v in ranges.SYNCS.items()
             if v != before[0].get(k, 0)},
            {k: v - before[1].get(k, 0.0) for k, v in ranges.SYNC_SECONDS.items()
             if v != before[1].get(k, 0.0)})


def snapshot():
    from pace_tpu_torch.utils import ranges

    return dict(ranges.SYNCS), dict(ranges.SYNC_SECONDS)


def reused():
    """Calls of ``scalar_like`` so far that reused a tensor made earlier, read
    through ``counters()``, which a revision without the counter answers
    with 0 (the tool can be copied into an older checkout to compare)."""
    from pace_tpu_torch.utils import ranges

    return ranges.counters().get("scalar_like.reused", 0)


def state_digest(state):
    """sha256 of the bytes of every tensor field of ``state``, in field order:
    two runs with the same seed give the same digest when every field is the
    same bit for bit."""
    import dataclasses
    import hashlib

    h = hashlib.sha256()
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if isinstance(t, torch.Tensor):
            h.update(f.name.encode())
            h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def census_step(driver, census):
    before = snapshot()
    reused0 = reused()
    step = driver._step_count + 1
    records = census.run(driver.step_all, driver.device.type == "cuda")
    counts, _ = syncs_delta(before)
    by_site = collections.Counter(r["site"] or "(uncovered)" for r in records)
    callers = collections.Counter(f"{r['site']} <- {r['caller']}" for r in records if r["site"])
    uncovered = collections.Counter(" | ".join(r["stack"]) for r in records if not r["site"])
    return {"step": step, "warnings": len(records), "host_syncs": sum(counts.values()),
            "scalar_like_reused": reused() - reused0,
            "warnings_by_site": dict(by_site), "host_syncs_by_site": counts,
            "callers": dict(callers.most_common()), "uncovered": dict(uncovered.most_common())}


class CallerClock:
    """Host seconds of each caller of ``stencil_utils.scalar_like``, timed by
    a stand-in put into every module that imported it by name."""

    def __init__(self):
        import importlib

        from pace_tpu_torch.ops import stencil_utils

        self.inner = stencil_utils.scalar_like
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.modules = [m for m in (importlib.import_module(f"pace_tpu_torch.{n}") for n in (
            "models.fv3.dycore", "models.fv3.acoustics", "ops.dycore_extras", "ops.remapping",
            "ops.nonhydro", "ops.ppm")) if getattr(m, "scalar_like", None) is self.inner]

    def __enter__(self):
        inner, seconds, calls = self.inner, self.seconds, self.calls

        def timed(x, like):
            f = sys._getframe(1)
            key = f"{Path(f.f_code.co_filename).relative_to(ROOT)}:{f.f_lineno} {f.f_code.co_name}"
            t = time.perf_counter()
            out = inner(x, like)
            seconds[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        for m in self.modules:
            m.scalar_like = timed
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.scalar_like = self.inner


def host_ranges(events):
    """``(name, start_us, end_us)`` of every user range on the host, on the
    trace's clock."""
    from torch.autograd import DeviceType

    return sorted(((e.name, float(e.time_range.start), float(e.time_range.end))
                   for e in events if e.device_type == DeviceType.CPU and e.is_user_annotation),
                  key=lambda r: (r[1], -r[2]))


def gaps(ops):
    """``(start_us, end_us, op that ended last, op that ends the gap)`` of
    every idle gap between device operations."""
    out, end, last = [], None, None
    for op in sorted(ops, key=lambda o: o.start_us):
        if end is not None and op.start_us > end:
            out.append((end, op.start_us, last, op))
        b = op.start_us + op.dur_us
        if end is None or b > end:
            end, last = b, op
    return out


def innermost_at(ranges_, times):
    """The innermost host range open at each of the sorted ``times``
    (``"(no range)"`` outside every range)."""
    out, stack, r = [], [], 0
    for t in times:
        while r < len(ranges_) and ranges_[r][1] <= t:
            while stack and stack[-1][2] < ranges_[r][1]:
                stack.pop()
            stack.append(ranges_[r])
            r += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        open_ = [x for x in stack if x[2] >= t]
        out.append(open_[-1][0] if open_ else "(no range)")
    return out


def trace_steps(driver, device, n):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    end_of_step = driver._end_of_step_actions

    def spanned_end_of_step():
        with torch.profiler.record_function("bench.end_of_step"):
            end_of_step()

    walls = []
    driver._end_of_step_actions = spanned_end_of_step
    try:
        with profile(activities=activities) as prof:
            harness._sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                t = time.perf_counter()
                with torch.profiler.record_function("bench.step"):
                    driver.step_all()
                walls.append((driver._step_count, time.perf_counter() - t))
            harness._sync(device)
            stretch = time.perf_counter() - t0
    finally:
        del driver._end_of_step_actions
    events = prof.events()
    return trace.device_ops(events), host_ranges(events), stretch, walls


def analyse_trace(ops, hr, stretch, n):
    from benchmark.metrics import sync_idle_ms

    total = sum(o.dur_us for o in ops)
    outside = sum(o.dur_us for o in ops if all(s.startswith("bench.") for s in o.scopes))
    g = gaps(ops)
    at_start = innermost_at(hr, [a for a, _b, _l, _o in g])
    by_start = collections.defaultdict(float)
    sync_idle = 0.0
    for (a, b, _last, _op), name in zip(g, at_start):
        by_start[name] += b - a
        if name.startswith("HostSync."):
            sync_idle += b - a
    idle = sum(b - a for a, b, _l, _o in g)

    def in_sync(op):
        return any(s.startswith("HostSync.") for s in op.scopes)

    # the longest gaps on which the host ranges and the reader disagree,
    # with the host ranges open around the gap's start
    def around(t, width=50.0):
        return [(nm, round(a - t, 1), round(b - t, 1)) for nm, a, b in hr
                if a <= t + width and b >= t - width][-6:]
    disagree = sorted(((b - a, a, name, last, nxt) for (a, b, last, nxt), name
                       in zip(g, at_start) if name.startswith("HostSync.") != in_sync(last)),
                      key=lambda x: -x[0])[:25]
    disagreements = [{"idle_us": round(d, 1), "range_at_start": name,
                      "last": [last.name[:50], list(last.scopes[-3:]),
                               round(last.start_us - a, 1), round(last.dur_us, 1)],
                      "next": [nxt.name[:50], list(nxt.scopes[-3:])],
                      "host_ranges_near_start": around(a)}
                     for d, a, name, last, nxt in disagree]
    ctx = harness.MetricContext(ops=ops, profiled_steps=n, stretch_seconds=stretch,
                                profiled_subcycles=[], window=harness.Window(),
                                step_config=None, shapes=None, physics_walls=[])
    return {
        "device_us": total, "outside_program_us": outside,
        "outside_program_share": outside / total if total else None,
        "busy_s": trace.busy_seconds(ops), "stretch_s": stretch,
        "idle_ms_per_step": idle / 1e3 / n,
        "idle_by_range_at_gap_start_ms_per_step": dict(sorted(
            ((k, v / 1e3 / n) for k, v in by_start.items()), key=lambda kv: -kv[1])),
        "idle_by_range_at_gap_end_ms_per_step": {k: v * 1e3 / n
                                                 for k, v in trace.idle_gaps(ops)},
        "sync_idle_ms_from_host_ranges": sync_idle / 1e3 / n,
        "sync_idle_ms_reader": sync_idle_ms.read(ctx),
        "disagreements": disagreements,
        "no_range_ops": collections.Counter(
            o.name[:60] for o in ops if all(s.startswith("bench.") for s in o.scopes)
        ).most_common(8),
    }


def run_cell(name, seed, window, device, shrink=None):
    from pace_tpu_torch.utils import ranges

    t_start = time.perf_counter()
    cell = registry.workload(name)
    cfg = registry.config(cell["config"])
    raw = registry.driver_dict(cell, cfg)
    if shrink:
        raw = registry.merge(raw, shrink)
    run_dir = ROOT / "build" / "sync_census" / name
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    raw = registry.merge(raw, {"minutes": 0, "hours": 0, "days": 0,
                               "seconds": int(raw["dt_atmos"]),
                               "diagnostics_config": {"path": str(run_dir / "diagnostics")}})
    recipes = cfg.get("inputs", []) + cell.get("inputs", [])
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        driver = program.build_driver(raw, device)
        h = driver.metric_terms.spec.n_halo
        driver.state = harness.apply_inputs(driver.state, recipes, seed, h)
        driver.step_all()
        harness._sync(device)
        out = {"cell": name, "seed": seed, "setup_s": time.perf_counter() - t_start}
        freq = driver.config.diagnostics_config.output_frequency
        census = Census(host_sync_blocks())
        out["census_window_step"] = census_step(driver, census)
        while (driver._step_count + 1) % freq:
            driver.step_all()
        out["census_output_step"] = census_step(driver, census)

        # the unprofiled window: whole diagnostics cycles
        before = snapshot()
        reused0 = reused()
        clocks0 = dict(driver.timer.times), dict(driver.timer.hits)
        walls = []
        harness._sync(device)
        t0 = time.perf_counter()
        for _ in range(window):
            t = time.perf_counter()
            driver.step_all()
            walls.append((driver._step_count, time.perf_counter() - t))
        harness._sync(device)
        seconds = time.perf_counter() - t0
        counts, secs = syncs_delta(before)
        out["window"] = {
            "steps": window, "seconds": seconds, "step_walls": walls,
            "syncs_per_step": {k: v / window for k, v in counts.items()},
            "sync_ms_per_step": {k: 1e3 * v / window for k, v in secs.items()},
            "host_syncs_per_step": sum(counts.values()) / window,
            "host_sync_ms": 1e3 * sum(secs.values()) / window,
            "scalar_like_reused_per_step": (reused() - reused0) / window,
            "state_step": driver._step_count,
            "state_sha256": state_digest(driver.state),
            "clock_ms_per_step": {k: 1e3 * (v - clocks0[0].get(k, 0.0)) / window
                                  for k, v in driver.timer.times.items()},
            "clock_hits": {k: v - clocks0[1].get(k, 0) for k, v in driver.timer.hits.items()},
            "counters": ranges.counters(),
        }
        hits = out["window"]["clock_hits"].get("Diagnostics", 0)
        out["window"]["diagnostics_ms"] = (
            1e3 * (driver.timer.times["Diagnostics"] - clocks0[0].get("Diagnostics", 0.0)) / hits
            if hits else None)

        # the callers of scalar_like, timed apart over as many more steps
        with CallerClock() as cc:
            for _ in range(window):
                driver.step_all()
        out["scalar_like_callers"] = {
            k: {"calls_per_step": cc.calls[k] / window, "ms_per_step": 1e3 * v / window}
            for k, v in sorted(cc.seconds.items(), key=lambda kv: -kv[1])}

        # the traced stretch, as the benchmark takes it
        while driver._step_count % freq:
            driver.step_all()
        n = cell["profile_steps"]
        ops, hr, stretch, twalls = trace_steps(driver, device, n)
        out["trace"] = analyse_trace(ops, hr, stretch, n)
        out["trace"]["step_walls"] = twalls
        plain = [w for s, w in walls if s % freq]
        traced = [w for s, w in twalls if s % freq]
        out["tracing_cost"] = {
            "untraced_ms": 1e3 * sum(plain) / len(plain) if plain else None,
            "traced_ms": 1e3 * sum(traced) / len(traced) if traced else None}
        del ops, hr
        return out
    finally:
        os.chdir(cwd)
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(registry.workload_names()))
    ap.add_argument("--seed", type=int, default=2147483907)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--out", default="build/sync_census.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", default="", help="JSON merged into the driver dict (the "
                    "CPU rehearsal's small sizes)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    shrink = json.loads(args.shrink) if args.shrink else None
    if device.type == "cuda":
        program.build_kernels()
    print(f"card: {harness.power_limit()}; torch {torch.__version__}", flush=True)
    results = []
    for name in args.cells.split(","):
        try:
            r = run_cell(name, args.seed, args.window, device, shrink)
        except Exception:
            traceback.print_exc()
            r = {"cell": name, "error": traceback.format_exc()}
        results.append(r)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1, default=str))
        if "error" in r:
            continue
        w, c1, c2, tr = r["window"], r["census_window_step"], r["census_output_step"], r["trace"]
        print(f"[{name}] census: window step {c1['warnings']} warnings / {c1['host_syncs']} "
              f"host_syncs ({c1['warnings_by_site'].get('(uncovered)', 0)} uncovered, "
              f"scalar_like.reused {c1['scalar_like_reused']}); output "
              f"step {c2['warnings']} / {c2['host_syncs']} "
              f"({c2['warnings_by_site'].get('(uncovered)', 0)} uncovered, "
              f"scalar_like.reused {c2['scalar_like_reused']})", flush=True)
        print(f"[{name}] window: {1e3 * w['seconds'] / w['steps']:.3f} ms a step, "
              f"host_syncs_per_step {w['host_syncs_per_step']:.3f}, scalar_like.reused a step "
              f"{w['scalar_like_reused_per_step']:.3f}, host_sync_ms "
              f"{w['host_sync_ms']:.3f}, diagnostics_ms {w['diagnostics_ms']}, clocks "
              + json.dumps({k: round(v, 3) for k, v in w["clock_ms_per_step"].items()}),
              flush=True)
        print(f"[{name}] sites/step " + json.dumps({k: round(v, 3) for k, v in
                                                    w["syncs_per_step"].items()})
              + " ms/step " + json.dumps({k: round(v, 3) for k, v in
                                          w["sync_ms_per_step"].items()}), flush=True)
        print(f"[{name}] state after step {w['state_step']}: sha256 {w['state_sha256']}",
              flush=True)
        print(f"[{name}] trace: outside program {tr['outside_program_share']}, idle "
              f"{tr['idle_ms_per_step']:.3f} ms/step, busy {tr['busy_s']:.3f} s of "
              f"{tr['stretch_s']:.3f}, sync_idle host ranges "
              f"{tr['sync_idle_ms_from_host_ranges']:.3f} reader {tr['sync_idle_ms_reader']}; "
              f"tracing cost {r['tracing_cost']}", flush=True)
        print(f"[{name}] idle at gap start " + json.dumps(
            {k: round(v, 3) for k, v in list(tr["idle_by_range_at_gap_start_ms_per_step"]
                                             .items())[:10]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
