"""Device ms per profiled step inside the ``DynCore`` range, the innermost of
the harness's stages (HaloExchange, DynCore, TracerAdvection, Remapping)
winning.
The acoustic loop: DynCore without its halo exchanges."""

from . import stage_ms_per_step


def read(ctx):
    return stage_ms_per_step(ctx, "DynCore")
