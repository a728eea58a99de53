"""Device idle ms per profiled step in the gaps that begin while the host
waits on the card: a gap that begins when a device operation launched inside
a ``HostSync.<site>`` range ends (the program's ``utils/ranges.host_sync``:
an ``.item()``, a copy to or from the host that waits for the stream). The
host was blocked on that operation, so the gap begins inside the range, and
the card stays idle until the host has issued its next launch.

A synchronize that launches nothing (the step's ``step_end``) leaves no
operation to find it by, and its gap is not counted here. None where no
operation was launched inside a ``HostSync`` range: a program without the
ranges, or a trace with no device operations (the CPU)."""


def _in_sync(op) -> bool:
    return any(s.startswith("HostSync.") for s in op.scopes)


def read(ctx):
    if not any(_in_sync(op) for op in ctx.ops):
        return None
    idle_us, end, last = 0.0, None, None
    for op in sorted(ctx.ops, key=lambda o: o.start_us):
        if end is not None and op.start_us > end and _in_sync(last):
            idle_us += op.start_us - end
        b = op.start_us + op.dur_us
        if end is None or b > end:
            end, last = b, op
    return idle_us / 1e3 / ctx.profiled_steps
