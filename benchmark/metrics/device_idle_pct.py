"""Share of the profiled stretch of whole steps in which no device operation
(kernel, copy or set) ran, in percent of the stretch's host wall time."""


def read(ctx):
    if not ctx.ops or ctx.stretch_seconds <= 0:
        return None
    from ..trace import busy_seconds

    return 100.0 * (1.0 - busy_seconds(ctx.ops) / ctx.stretch_seconds)
