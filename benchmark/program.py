"""The system under test: the port's driver, ``pace_tpu_torch.driver``.

The only module of the benchmark that imports the program. It builds the
``Driver`` from a driver dict as ``python -m pace_tpu_torch.driver.run``
builds it from a yaml, and hands back what the harness reads: the state,
the grid, the physics' surface state, the step's clocks and counts, as
the ``Driver``'s own attributes. With ``mesh_config.enabled`` the driver
takes the running process group and holds this rank's block of the shards
(``Driver.mesh``: its ``lo``, ``hi`` and ``n_shards``).
"""

from __future__ import annotations

import logging


def build_driver(raw: dict, device):
    """``Driver(DriverConfig.from_dict(raw), device)``: the grid, the initial
    state, the dynamical core, the physics, the diagnostics and the safety
    checks; the kernel libraries are loaded at their first launch."""
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver

    # the driver logs every call of step_all at INFO
    logging.getLogger("pace_tpu_torch").setLevel(logging.WARNING)
    return Driver(DriverConfig.from_dict(raw), device=device)


def build_kernels() -> None:
    """Build every kernel library not built yet (one ``nvcc`` each, all at
    once) into the program's build directory inside the checkout."""
    from pace_tpu_torch import _build

    _build.build()

