"""DriverConfig: the single YAML-backed configuration tree.

Port of ``pace_tpu.driver.config`` (reference role: ``DriverConfig``), with
the same fields, defaults and strictness: the top-level fields (nx_tile, nz,
layout, dt_atmos, ...) are derived into the dycore config and forbidden
inside it; ``{type, config}`` sections select initialization, grid and
diagnostics; unknown keys raise (:func:`pace_tpu_torch.utils.registry.from_dict`).
The configs hold the port's own classes (``DynamicalCoreConfig`` and, through
the physics section's dicts, the physics configs), and the files are read
and written by the port's YAML subset reader
(:mod:`pace_tpu_torch.utils.yaml_subset`), which resolves scalars as
PyYAML's ``safe_load`` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Mapping, Optional, Tuple

from ..models.fv3.dycore import DynamicalCoreConfig
from ..utils import yaml_subset
from ..utils.registry import ConfigError, from_dict
from .diagnostics import DiagnosticsConfig
from .grid import GridConfig
from .initialization import InitializationConfig
from .performance import PerformanceConfig

#: top-level fields derived into the dycore config, forbidden inside it
_DERIVED = ("npx", "npy", "npz", "ntiles", "layout", "dt_atmos")


@dataclasses.dataclass(frozen=True)
class SafetyCheckConfig:
    variable: str
    minimum_value: Optional[float] = None
    maximum_value: Optional[float] = None
    compute_domain_only: bool = True


@dataclasses.dataclass(frozen=True)
class RestartConfig:
    save_restart: bool = False
    intermediate_restart: Tuple[int, ...] = ()
    save_intermediate_restart: bool = False
    path: str = "RESTART"


@dataclasses.dataclass(frozen=True)
class PhysicsEnableConfig:
    """Scheme selection and per-scheme options."""

    schemes: Tuple[str, ...] = ()
    #: per-scheme option dicts -> MicrophysicsConfig / PBLConfig /
    #: GrayRadiationConfig fields
    microphysics: Optional[dict] = None
    pbl: Optional[dict] = None
    radiation: Optional[dict] = None
    #: multi-band radiation options -> BandRadiationConfig
    band_radiation: Optional[dict] = None
    shallow_convection: Optional[dict] = None
    deep_convection: Optional[dict] = None
    held_suarez: Optional[dict] = None
    #: interactive lower boundary (SurfaceConfig fields;
    #: type: none|land|seaice|mixed)
    surface: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The shard mesh: ``enabled`` splits the run over the ranks of
    torch.distributed (``parallel/mesh.py``; ``torchrun --nproc-per-node N
    python -m pace_tpu_torch.driver.run <yaml>``), each rank a contiguous
    block of the ``6*ly*lx`` shards. ``n_devices``: the rank count the
    config expects (default: the process group's); ``distributed`` is
    accepted for ``pace_tpu``'s configs, the rendezvous coming from the
    environment either way."""

    enabled: bool = False
    n_devices: Optional[int] = None
    distributed: bool = False


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Halo-exchange backend: ``exchange`` (the real exchange), ``null``
    (every ghost set to ``fill_value``), ``write`` (the exchange, every
    result recorded and saved to ``path`` at the end of the run) or
    ``read`` (the recording at ``path`` replayed, no exchange);
    ``parallel/strategies.py``."""

    type: str = "exchange"
    fill_value: float = 0.0
    path: str = "halo_recording.npz"


@dataclasses.dataclass
class DriverConfig:
    """``pace_tpu``'s fields and defaults (reference role: driver.py's
    DriverConfig)."""

    stencil_config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    initialization: InitializationConfig = dataclasses.field(
        default_factory=InitializationConfig
    )
    nx_tile: int = 12
    nz: int = 79
    layout: Tuple[int, int] = (1, 1)
    dt_atmos: float = 225.0
    diagnostics_config: DiagnosticsConfig = dataclasses.field(
        default_factory=DiagnosticsConfig
    )
    performance_config: PerformanceConfig = dataclasses.field(
        default_factory=PerformanceConfig
    )
    dycore_config: DynamicalCoreConfig = dataclasses.field(
        default_factory=DynamicalCoreConfig
    )
    physics_config: PhysicsEnableConfig = dataclasses.field(
        default_factory=PhysicsEnableConfig
    )
    grid_config: GridConfig = dataclasses.field(default_factory=GridConfig)
    comm_config: CommConfig = dataclasses.field(default_factory=CommConfig)
    mesh_config: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    restart_config: RestartConfig = dataclasses.field(default_factory=RestartConfig)
    safety_checks: List[SafetyCheckConfig] = dataclasses.field(
        default_factory=lambda: [
            # pace_tpu's defaults: the prognostic pt is virtual potential
            # temperature, so its bounds are wider than the reference's
            # temperature bounds; the NaN checks always run
            SafetyCheckConfig("u", -300.0, 300.0),
            SafetyCheckConfig("v", -300.0, 300.0),
            SafetyCheckConfig("delp", -1.0, 60000.0),
            SafetyCheckConfig("pt", 100.0, 10000.0),
        ]
    )
    days: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    pair_debug: bool = False
    #: per-stage NaN / negative-delp / negative-tracer sanitizer
    debug_checks: bool = False
    precision: int = 32
    #: run just the dycore even when physics schemes are configured (the
    #: dry convective adjustment still runs)
    dycore_only: bool = False
    disable_step_physics: bool = False

    @property
    def total_time_seconds(self) -> float:
        return (
            self.days * 86400 + self.hours * 3600 + self.minutes * 60 + self.seconds
        )

    @property
    def n_timesteps(self) -> int:
        return int(self.total_time_seconds / self.dt_atmos)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "DriverConfig":
        data = dict(data)
        dyc = dict(data.get("dycore_config", {}))
        for forbidden in _DERIVED:
            if forbidden in dyc:
                raise ConfigError(
                    f"dycore_config must not set {forbidden}; it is derived "
                    "from the top-level config"
                )
        dyc["npz"] = data.get("nz", 79)
        data["dycore_config"] = dyc
        return from_dict(cls, data)

    @classmethod
    def from_yaml(cls, path: str) -> "DriverConfig":
        with open(path) as f:
            return cls.from_dict(yaml_subset.safe_load(f))

    def write_for_restart(self, path: str, start_time_seconds: float) -> None:
        """Write a restart.yaml that points initialization at the restart
        files in ``path``."""
        raw = dataclasses.asdict(self)
        raw["initialization"] = {
            "type": "restart",
            "config": {"path": os.path.abspath(path),
                       "start_time_seconds": start_time_seconds},
        }
        # the dycore config carries the derived fields, which from_dict
        # forbids inside it: strip them so that restart.yaml loads again
        dyc = dict(raw.get("dycore_config") or {})
        for forbidden in _DERIVED:
            dyc.pop(forbidden, None)
        raw["dycore_config"] = dyc
        with open(os.path.join(path, "restart.yaml"), "w") as f:
            f.write(yaml_subset.dump(_jsonify(raw)))


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj
