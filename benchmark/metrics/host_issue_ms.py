"""The host's ms to issue one step of the unprofiled window: the driver's
``"mainloop"`` clock, which stops before the step's synchronize."""


def read(ctx):
    w = ctx.window
    if w.steps == 0:
        return None
    return 1e3 * w.issue_seconds / w.steps
