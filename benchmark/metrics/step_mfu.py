"""The whole step's share of the chip's peak: the work model's bound for the
window's steps (at the tracer sub-cycles each took) over the unprofiled
window's wall time, in percent. The glue counts as no work, so this is a
floor on the step's real share."""


def read(ctx):
    w = ctx.window
    if w.steps == 0 or w.seconds <= 0:
        return None
    return 100.0 * sum(ctx.step_bound(sub) for sub in w.subcycles) / w.seconds
