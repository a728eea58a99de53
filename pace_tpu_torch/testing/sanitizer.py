"""Numerical sanitizer: per-stage NaN / negative-delp / negative-tracer
checks inside the dycore.

Port of ``pace_tpu.testing.sanitizer`` (reference role: the
``PACE_DACE_DEBUG`` passes: a NaN checker on every written field,
negative-tracer and negative-delp checkers, a progress print). It plugs into
the stage-checkpointer hook, so the granularity is one savepoint stage
(C_SW/D_SW/Tracer2D1L/Remapping/FVDynamics In/Out) rather than one kernel;
each stage takes its variables to the host, so a sanitized run is a debug
run, not a production one.

Enable from a driver yaml with ``debug_checks: true`` or use directly::

    core = DynamicalCore(..., checkpointer=SanitizerCheckpointer())
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger
from .checkpointer import _concrete

logger = get_logger()


class SanitizerError(AssertionError):
    pass


class SanitizerCheckpointer:
    """Check every (stage, variable) it sees; raise at the first failure.

    ``tracer_floor``: negative-tracer tolerance (the reference model fills
    small negatives via neg_adj3, so only below-floor values are bugs).
    ``progress``: log each stage hit (the per-kernel progress print analog —
    shows where a crash/hang happened).
    """

    def __init__(
        self,
        tracer_floor: float = -1.0e-8,
        progress: bool = False,
        collect: bool = False,
        n_halo: int = 3,
    ):
        self.tracer_floor = float(tracer_floor)
        self.progress = progress
        #: collect=True records failures instead of raising (for tests)
        self.collect = collect
        #: ghost zones legitimately hold stale values between exchanges —
        #: only the compute interior is checked
        self.n_halo = int(n_halo)
        self.failures: List[str] = []
        self._hit = 0

    def _fail(self, msg: str):
        if self.collect:
            self.failures.append(msg)
            return
        raise SanitizerError(msg)

    def __call__(self, stage: str, **variables):
        self._hit += 1
        if self.progress:
            logger.info("sanitizer: stage %s (hit %d)", stage, self._hit)
        h = self.n_halo
        for name, val in variables.items():
            if val is None:
                continue
            arr = _concrete(val)
            if h > 0 and arr.ndim >= 2 and min(arr.shape[-2:]) > 2 * h:
                arr = arr[..., h:-h, h:-h]
            bad = ~np.isfinite(arr)
            if bad.any():
                idx = np.unravel_index(np.argmax(bad), arr.shape)
                self._fail(
                    f"{stage}.{name}: {int(bad.sum())} non-finite values, "
                    f"first at {idx}"
                )
            if name == "delp":
                neg = arr <= 0.0
                if neg.any():
                    idx = np.unravel_index(np.argmax(neg), arr.shape)
                    self._fail(
                        f"{stage}.delp: {int(neg.sum())} non-positive layer "
                        f"thicknesses, first at {idx} (delp={arr[idx]:g})"
                    )
            if name == "q":
                neg = arr < self.tracer_floor
                if neg.any():
                    idx = np.unravel_index(np.argmax(neg), arr.shape)
                    self._fail(
                        f"{stage}.q: {int(neg.sum())} tracer values below "
                        f"{self.tracer_floor:g}, first at {idx} "
                        f"(q={arr[idx]:g})"
                    )


def make_sanitizer(config: Optional[dict] = None) -> SanitizerCheckpointer:
    cfg = dict(config or {})
    return SanitizerCheckpointer(
        tracer_floor=float(cfg.get("tracer_floor", -1.0e-8)),
        progress=bool(cfg.get("progress", False)),
        n_halo=int(cfg.get("n_halo", 3)),
    )
