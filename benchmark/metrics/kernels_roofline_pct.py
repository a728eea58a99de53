"""The hand-written kernels' share of their roofline: the work model's bound
over the profiled steps, summed over the operators whose kernels the trace
shows, divided by those kernels' summed device time, in percent."""

import collections

from .. import workmodel as wm
from . import operator_of


def read(ctx):
    time_s = collections.defaultdict(float)
    for op in ctx.ops:
        name = operator_of(op.name)
        if name is not None:
            time_s[name] += op.dur_us / 1e6
    if not time_s:
        return None
    bound = 0.0
    for sub in ctx.profiled_subcycles:
        per_op = wm.step_bound(ctx.step_config, ctx.shapes, sub)
        bound += sum(v for k, v in per_op.items() if k in time_s)
    return 100.0 * bound / sum(time_s.values())
