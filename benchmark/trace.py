"""Reading a ``torch.profiler`` trace of whole steps: every device operation
with its time, its name and the host ranges open when it was launched.

The attribution is a frozen copy of the program's
``driver/stage_profile.py`` (``kernel_scopes``, ``attribute_stages``): each
device operation belongs to the ranges (``utils/ranges.stage_range``, and
the benchmark's own ``bench.*`` spans) that were open on the host when its
launch was issued, and its time goes to the innermost of the stages asked
for. It is extended to keep each operation's name and start, so that busy
time, idle gaps and kernel names can be read from the same list.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    #: host ranges open at the launch, outermost first
    scopes: Tuple[str, ...]

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def device_ops(events) -> List[DeviceOp]:
    """Every device operation (kernel, copy, set) among a finished
    profile's ``events()``, placed among the host ranges that contain its
    launch (the CUDA runtime call with the same correlation id)."""
    from torch.autograd import DeviceType

    ranges = sorted((e for e in events
                     if e.device_type == DeviceType.CPU and e.is_user_annotation),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    names = {r.name for r in ranges}
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    device = [d for d in events if d.device_type == DeviceType.CUDA
              and not d.is_user_annotation and d.name not in names]
    order = sorted(device, key=lambda d: launch_at.get(d.id, -1.0))
    out, stack, r = [], [], 0
    for d in order:
        t = launch_at.get(d.id)
        scopes: Tuple[str, ...] = ()
        if t is not None:
            while r < len(ranges) and ranges[r].time_range.start <= t:
                while stack and stack[-1].time_range.end < ranges[r].time_range.start:
                    stack.pop()
                stack.append(ranges[r])
                r += 1
            while stack and stack[-1].time_range.end < t:
                stack.pop()
            scopes = tuple(x.name for x in stack if x.time_range.end >= t)
        out.append(DeviceOp(d.name, float(d.time_range.start), float(d.time_range.elapsed_us()),
                            scopes))
    return out


def split_nccl(ops: Sequence[DeviceOp]) -> Tuple[List[DeviceOp], float]:
    """The operations other than NCCL's kernels, and the seconds of those.
    An NCCL kernel spins on the card while it waits for its peers, so its
    time is a wait as much as a transfer, and no metric may read it as
    work (on one card there is none)."""
    work = [op for op in ops if not op.name.startswith("nccl")]
    return work, sum(op.dur_us for op in ops if op.name.startswith("nccl")) / 1e6


def attribute(ops: Iterable[DeviceOp], stages: Sequence[str]) -> Dict[str, float]:
    """Device seconds per stage: each operation to the innermost of its
    ranges that is one of ``stages``, else to ``"other"``."""
    agg: Dict[str, float] = collections.defaultdict(float)
    wanted = set(stages)
    for op in ops:
        for name in reversed(op.scopes):
            if name in wanted:
                agg[name] += op.dur_us / 1e6
                break
        else:
            agg["other"] += op.dur_us / 1e6
    return dict(agg)


def busy_seconds(ops: Iterable[DeviceOp]) -> float:
    """Seconds in which at least one device operation ran (the union of
    their intervals)."""
    total, end = 0.0, None
    for op in sorted(ops, key=lambda o: o.start_us):
        a, b = op.start_us, op.start_us + op.dur_us
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def idle_gaps(ops: Sequence[DeviceOp]) -> List[Tuple[str, float]]:
    """Idle seconds between device operations, summed by what the host was
    doing: the innermost host range open at the launch of the operation
    that ends the gap (``"(no range)"`` outside every range), longest
    first."""
    agg: Dict[str, float] = collections.defaultdict(float)
    end = None
    for op in sorted(ops, key=lambda o: o.start_us):
        if end is not None and op.start_us > end:
            agg[op.scopes[-1] if op.scopes else "(no range)"] += (op.start_us - end) / 1e6
        b = op.start_us + op.dur_us
        end = b if end is None else max(end, b)
    return sorted(agg.items(), key=lambda kv: -kv[1])


def top_ops(ops: Iterable[DeviceOp], n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device operations that took most time, by trace name."""
    agg: Dict[str, float] = collections.defaultdict(float)
    for op in ops:
        agg[op.name] += op.dur_us / 1e6
    return sorted(agg.items(), key=lambda kv: -kv[1])[:n]
