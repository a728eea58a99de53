"""Device ms per profiled step of every kernel that is none of the 14 FV3
operators' hand-written kernels: PyTorch's own elementwise, copy and
reduction kernels (copies and sets of memory are not kernels)."""

from . import operator_of


def read(ctx):
    kernels = [op for op in ctx.ops if op.is_kernel]
    if not kernels:
        return None
    return 1e3 * sum(op.dur_us / 1e6 for op in kernels
                     if operator_of(op.name) is None) / ctx.profiled_steps
