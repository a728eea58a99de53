"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer`` list, found by the metric's name.

Each has ``read(ctx) -> float | None``, ``ctx`` a
:class:`benchmark.harness.MetricContext` of the traced run: the profiled
stretch's device operations with their host ranges, the unprofiled window's
steps, seconds and issue time, the work model's configuration and shapes,
and the physics spans' wall times. A reader that finds nothing to read
returns None, and the metric is left out of the result line.
"""

import re

from .. import workmodel as wm

_KERNEL_RE = {op: re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(names) + r")(?![A-Za-z0-9_])")
              for op, names in wm.KERNELS.items()}


def operator_of(name: str):
    """The FV3 operator whose kernel a trace name is, or None (the glue)."""
    for op, rx in _KERNEL_RE.items():
        if rx.search(name):
            return op
    return None


def stage_ms_per_step(ctx, stage: str):
    """Device ms a profiled step spends in ``stage`` (innermost of the
    harness's stages), or None without a device operation."""
    if not ctx.ops:
        return None
    return 1e3 * ctx.stage_seconds().get(stage, 0.0) / ctx.profiled_steps
