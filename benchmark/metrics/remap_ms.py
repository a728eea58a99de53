"""Device ms per profiled step inside the ``Remapping`` range, the innermost of
the harness's stages (HaloExchange, DynCore, TracerAdvection, Remapping)
winning."""

from . import stage_ms_per_step


def read(ctx):
    return stage_ms_per_step(ctx, "Remapping")
