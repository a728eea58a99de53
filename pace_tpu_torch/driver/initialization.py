"""Pluggable initial conditions.

Port of ``pace_tpu.driver.initialization`` (reference role:
``InitializerSelector``): ``baroclinic``, ``analytic`` (case
``baroclinic``), ``predefined`` and ``restart`` are ported. A restart
directory in the Fortran format, and the types ``fortran_restart``,
``tropicalcyclone`` and ``savepoint``, raise ``NotImplementedError``, which
names the ROADMAP item that ports them.

``AnalyticInitConfig.moist`` is read and dropped, as ``pace_tpu`` drops it
(its initializer passes only ``perturbation``): configs with ``moist:
true`` start with every tracer at zero (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ..models.fv3.state import DycoreState

_NOT_PORTED = {
    "fortran_restart": "Fortran restarts (fortran_restart.py, ROADMAP queue 1 item 3)",
    "tropicalcyclone": "the tropical-cyclone initial state (init_tropical_cyclone.py, "
                       "ROADMAP queue 1 item 3)",
    "savepoint": "savepoint initialization (testing/translate.py, ROADMAP queue 1 item 8)",
}


@dataclasses.dataclass(frozen=True)
class AnalyticInitConfig:
    case: str = "baroclinic"
    perturbation: bool = True
    moist: bool = False


@dataclasses.dataclass(frozen=True)
class RestartInitConfig:
    path: str = "RESTART"
    start_time_seconds: float = 0.0


def is_fortran_restart(path: str) -> bool:
    """Whether ``path`` holds a Fortran-format restart, which the reference
    detects by the presence of ``fv_core.res.nc``."""
    return os.path.exists(os.path.join(path, "fv_core.res.nc"))


@dataclasses.dataclass
class InitializationConfig:
    type: str = "baroclinic"
    config: Optional[dict] = None

    def get_dycore_state(self, mt, device, dtype) -> DycoreState:
        from ..utils.registry import from_dict

        if self.type in _NOT_PORTED:
            raise NotImplementedError(f"{_NOT_PORTED[self.type]} is not ported yet")
        if self.type in ("baroclinic", "analytic"):
            cfg = from_dict(AnalyticInitConfig, self.config or {})
            case = cfg.case if self.type == "analytic" else "baroclinic"
            return DycoreState.from_analytic_init(
                mt, case=case, perturbation=cfg.perturbation, device=device, dtype=dtype
            )
        if self.type == "restart":
            cfg = from_dict(RestartInitConfig, self.config or {})
            if is_fortran_restart(cfg.path):
                raise NotImplementedError(
                    f"{cfg.path} holds a Fortran restart: "
                    f"{_NOT_PORTED['fortran_restart']} is not ported yet")
            from .restart import load_restart

            return load_restart(cfg.path, device, dtype)
        if self.type == "predefined":
            # the caller hands a ready-made state through the Python API
            if not isinstance(self.config, dict) or "dycore_state" not in self.config:
                raise ValueError(
                    "predefined initialization requires config={'dycore_state': "
                    "DycoreState} (Python API only, like the reference)"
                )
            return self.config["dycore_state"]
        raise NotImplementedError(f"initialization type {self.type!r}")
