"""Command line: ``python -m pace_tpu_torch.driver.run CONFIG.yaml``.

Port of ``pace_tpu.driver.run`` (reference role: the driver's run.py: yaml ->
DriverConfig -> Driver -> step_all -> cleanup, with ``--log-level``). The
run is on the card unless ``--device cpu`` asks for the CPU; without a card
``cuda`` raises. The command line uses ``argparse``: the port needs neither
``click`` nor ``yaml``.

Run::

    python -m pace_tpu_torch.driver.run examples/configs/baroclinic_c192.yaml
    python -m pace_tpu_torch.driver.run examples/configs/baroclinic_c12.yaml --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os

from ..utils.logging import AVAILABLE_LOG_LEVELS, get_logger
from .config import DriverConfig
from .driver import Driver

logger = get_logger()


def main(driver_config: DriverConfig, device="cuda") -> Driver:
    driver = Driver(driver_config, device=device)
    driver.step_all()
    driver.cleanup()
    return driver


def command_line(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pace_tpu_torch.driver.run",
                                 description="Run the model from a driver config file.")
    ap.add_argument("config_path", help="the driver's YAML config")
    ap.add_argument("--log-level", default="info", choices=sorted(AVAILABLE_LOG_LEVELS),
                    help="logging verbosity")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.config_path):
        ap.error(f"config file {args.config_path!r} does not exist")
    level = AVAILABLE_LOG_LEVELS[args.log_level]
    logging.getLogger().setLevel(level)
    logger.setLevel(level)
    logger.info("loading config %s", args.config_path)
    config = DriverConfig.from_yaml(args.config_path)
    main(config, device=args.device)


if __name__ == "__main__":
    command_line()
