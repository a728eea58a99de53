"""Named profiler ranges at the stage boundaries of the step.

``pace_tpu`` marks its stages with ``jax.named_scope`` (DynCore,
TracerAdvection, Remapping, HaloExchange, the acoustic substep's parts and
the physics schemes), and its driver attributes device time to them from a
trace. The port marks the same places with :func:`stage_range`, a
``torch.profiler.record_function`` range, which
:mod:`pace_tpu_torch.driver.stage_profile` reads. A range launches no kernel;
while no profiler is recording it is not even entered, so an unprofiled step
pays one flag test per range (about 3,000 a step of the C192 benchmark
configuration, most of them halo exchanges).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import _profiler_enabled

_NULL = contextlib.nullcontext()


def stage_range(name: str):
    """A context manager marking a stage ``name`` for the profiler."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
