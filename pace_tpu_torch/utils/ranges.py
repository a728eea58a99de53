"""Named profiler ranges at the stage boundaries of the step, and the places
where the host waits on the card.

``pace_tpu`` marks its stages with ``jax.named_scope`` (DynCore,
TracerAdvection, Remapping, HaloExchange, the acoustic substep's parts and
the physics schemes), and its driver attributes device time to them from a
trace. The port marks the same places with :func:`stage_range`, a
``torch.profiler.record_function`` range, which
:mod:`pace_tpu_torch.driver.stage_profile` reads. A range launches no kernel;
while no profiler is recording it is not even entered, so an unprofiled step
pays one flag test per range (about 3,000 a step of the C192 benchmark
configuration, most of them halo exchanges).

:func:`host_sync` marks a call that blocks the host until the card has
caught up: a ``.item()``, a device-to-host copy, a blocking copy of a Python
number to the card, a synchronize. Each entry adds one to ``SYNCS[site]``
and the wall seconds it blocked to ``SYNC_SECONDS[site]``, always (an
integer add and two clock reads, a few hundred a step); while a profiler
records it also opens the range ``HostSync.<site>``, on the same clock as
the device operations. On the CPU the sites are counted all the same,
though they wait on nothing there. :func:`counters` hands out the counts
with the kernel wrappers' launch counts in one flat dict.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

import torch
from torch.autograd import _profiler_enabled

_NULL = contextlib.nullcontext()

#: entries of each host_sync site since the process started
SYNCS: Dict[str, int] = collections.Counter()
#: wall seconds the host spent inside each host_sync site
SYNC_SECONDS: Dict[str, float] = collections.defaultdict(float)
#: calls of ``ops.stencil_utils.scalar_like`` that reused a tensor made earlier
#: (its misses are ``SYNCS["scalar_like"]``)
SCALAR_REUSES = 0

#: the kernel wrappers whose ``LAUNCHES`` :func:`counters` reads, by module
_LAUNCH_MODULES = (
    "parallel.halo_kernel", "ops.fvtp2d_kernel", "ops.d2a2c_kernel", "ops.c_sw_tail_kernel",
    "ops.hydro_kernel", "ops.updatedz_kernel", "ops.sim1_kernel", "ops.pgrad_kernel",
    "ops.d_sw_tail_kernel", "ops.remap_kernel",
)


def stage_range(name: str):
    """A context manager marking a stage ``name`` for the profiler."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class host_sync:
    """``with host_sync(site): <a call that waits on the card>``: counts the
    entry and its blocked seconds under ``site``, and marks it
    ``HostSync.<site>`` for a recording profiler."""

    __slots__ = ("site", "_t0", "_range")

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        self._range = stage_range(f"HostSync.{self.site}")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        SYNC_SECONDS[self.site] += time.perf_counter() - self._t0
        SYNCS[self.site] += 1
        return self._range.__exit__(*exc)


def counters() -> Dict[str, float]:
    """One flat dict of the process's counters so far:
    ``syncs.<site>`` and ``sync_seconds.<site>`` of every host_sync site,
    ``scalar_like.reused`` (:data:`SCALAR_REUSES`), and ``launches.<kernel>``
    of the ten kernel wrappers' ``LAUNCHES``, read in place."""
    import importlib

    out: Dict[str, float] = {}
    for site, n in SYNCS.items():
        out[f"syncs.{site}"] = n
    for site, s in SYNC_SECONDS.items():
        out[f"sync_seconds.{site}"] = s
    out["scalar_like.reused"] = SCALAR_REUSES
    for mod in _LAUNCH_MODULES:
        for kernel, n in importlib.import_module(f"pace_tpu_torch.{mod}").LAUNCHES.items():
            out[f"launches.{kernel}"] = n
    return out
