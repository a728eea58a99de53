"""Pluggable initial conditions.

Port of ``pace_tpu.driver.initialization`` (reference role:
``InitializerSelector``): ``baroclinic``, ``tropicalcyclone``, ``analytic``
(case ``baroclinic`` or ``tropicalcyclone``), ``predefined``, ``restart``
(the port's own restart files, or a Fortran restart directory, told apart
by ``fv_core.res.nc``), ``fortran_restart`` and ``savepoint`` (an
``FVDynamics-In`` file read by :class:`~pace_tpu_torch.testing.translate.
TranslateFVDynamics`).

``AnalyticInitConfig.moist`` is read and dropped, as ``pace_tpu`` drops it
(its initializer passes only ``perturbation``): configs with ``moist:
true`` start with every tracer at zero (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.fv3.state import DycoreState
from .fortran_restart import is_fortran_restart


@dataclasses.dataclass(frozen=True)
class AnalyticInitConfig:
    case: str = "baroclinic"
    perturbation: bool = True
    moist: bool = False


@dataclasses.dataclass(frozen=True)
class RestartInitConfig:
    path: str = "RESTART"
    start_time_seconds: float = 0.0


@dataclasses.dataclass
class InitializationConfig:
    type: str = "baroclinic"
    config: Optional[dict] = None

    def get_dycore_state(self, mt, device, dtype) -> DycoreState:
        from ..utils.registry import from_dict

        if self.type in ("baroclinic", "analytic", "tropicalcyclone"):
            cfg = from_dict(AnalyticInitConfig, self.config or {})
            case = cfg.case if self.type == "analytic" else self.type
            return DycoreState.from_analytic_init(
                mt, case=case, perturbation=cfg.perturbation, device=device, dtype=dtype
            )
        if self.type in ("restart", "fortran_restart"):
            cfg = from_dict(RestartInitConfig, self.config or {})
            if self.type == "fortran_restart" or is_fortran_restart(cfg.path):
                from .fortran_restart import load_fortran_restart

                return load_fortran_restart(cfg.path, mt, device, dtype)
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
        if self.type == "savepoint":
            # recorded savepoint data, read by the translate framework
            from ..testing.translate import TranslateFVDynamics

            cfg = dict(self.config or {})
            if "path" not in cfg:
                raise ValueError(
                    "savepoint initialization requires config={'path': "
                    "<savepoint .nc/.h5>, 'data_halo': <halo cells in the "
                    "serialized slabs, default 0>}"
                )
            tr = TranslateFVDynamics(mt, data_halo=int(cfg.get("data_halo", 0)), device=device,
                                     dtype=dtype)
            return tr.state_from_inputs(tr.collect_input_data(cfg["path"]))
        raise NotImplementedError(f"initialization type {self.type!r}")
