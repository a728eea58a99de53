"""Pure-Python helpers of the port: logging, the configuration registry, the
YAML subset reader, filesystem access, profiler ranges and the file formats
of the driver's IO (NetCDF-3 with its native IO core, zarr v2)."""

from .logging import AVAILABLE_LOG_LEVELS, pace_log, set_log_level
from .registry import ConfigError, Registry, from_dict

__all__ = [
    "pace_log",
    "set_log_level",
    "AVAILABLE_LOG_LEVELS",
    "Registry",
    "from_dict",
    "ConfigError",
]
