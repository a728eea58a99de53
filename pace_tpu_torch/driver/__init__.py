"""The driver: a YAML config to a model run.

Port of ``pace_tpu.driver`` (reference role: the driver package: run,
driver, config, initialization, grid, diagnostics, restart, safety checks,
performance, stage profile).
"""

from .config import DriverConfig  # noqa: F401
from .driver import Driver  # noqa: F401
