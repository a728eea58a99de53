"""Per-stage device time from a ``torch.profiler`` trace.

Port of ``pace_tpu.driver.stage_profile``. The reference reports the stage
timers "DynCore", "TracerAdvection" and "Remapping" of its mainloop;
``pace_tpu`` finds them as ``jax.named_scope``s in its compiled program's
op metadata. The port marks the same places with
:func:`pace_tpu_torch.utils.ranges.stage_range` (a
``torch.profiler.record_function`` range) and here gives each device
kernel's time to the innermost enclosing range that names a stage:

1. run one step under ``torch.profiler`` with CUDA activity;
2. for each kernel (and device copy or set), the ranges open on the host
   when it was launched;
3. sum the device seconds per stage; time outside every stage goes to
   ``"other"``.

On the CPU a trace holds no device events, and the result is ``{}``, as
``pace_tpu``'s is there.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Sequence, Tuple

import torch

STAGES = ("DynCore", "TracerAdvection", "Remapping")


def attribute_stages(
    kernels: Iterable[Tuple[float, Sequence[str]]], stages: Sequence[str] = STAGES
) -> Dict[str, float]:
    """Sum device seconds per stage. ``kernels`` holds one ``(duration in
    microseconds, enclosing range names from the outermost to the innermost)``
    per device event; each goes to its innermost range that is one of
    ``stages``, else to ``"other"``. Returns {} when there is no device
    event (the CPU)."""
    agg: Dict[str, float] = collections.defaultdict(float)
    wanted = set(stages)
    any_event = False
    for dur_us, scopes in kernels:
        any_event = True
        for name in reversed(scopes):
            if name in wanted:
                agg[name] += dur_us / 1e6
                break
        else:
            agg["other"] += dur_us / 1e6
    return dict(agg) if any_event else {}


def kernel_scopes(events) -> list:
    """``[(duration us, enclosing range names, outermost first)]`` of every
    device event (kernel, copy, set) among a finished profile's ``events()``.
    A device event's host launch (the CUDA runtime call with its correlation
    id) is placed in time among the ranges of :func:`stage_range` that
    contain it. Device-side copies of the ranges themselves are skipped."""
    from torch.autograd import DeviceType

    ranges = sorted((e for e in events
                     if e.device_type == DeviceType.CPU and e.is_user_annotation),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    names = {r.name for r in ranges}
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    device = [d for d in events if d.device_type == DeviceType.CUDA
              and not d.is_user_annotation and d.name not in names]
    # a sweep over the launches in time order with the stack of open
    # (properly nested) ranges
    order = sorted(device, key=lambda d: launch_at.get(d.id, -1.0))
    out, stack, r = [], [], 0
    for d in order:
        t = launch_at.get(d.id)
        if t is None:
            out.append((d.time_range.elapsed_us(), ()))
            continue
        while r < len(ranges) and ranges[r].time_range.start <= t:
            while stack and stack[-1].time_range.end < ranges[r].time_range.start:
                stack.pop()
            stack.append(ranges[r])
            r += 1
        while stack and stack[-1].time_range.end < t:
            stack.pop()
        out.append((d.time_range.elapsed_us(),
                    tuple(x.name for x in stack if x.time_range.end >= t)))
    return out


def profile_stage_times(fn, *args, stages: Sequence[str] = STAGES) -> Dict[str, float]:
    """Run ``fn(*args)`` once under the profiler and return device seconds
    per stage range. Empty dict on the CPU, which has no device events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return attribute_stages(kernel_scopes(prof.events()), stages)
