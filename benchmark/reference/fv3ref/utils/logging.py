"""Process-aware model logger.

Port of ``pace_tpu.utils.logging`` (reference role: ``ndsl.logging.ndsl_log``
with ``PACE_LOGLEVEL`` and ``--log-level``). The process index in each record
is the ``torch.distributed`` rank once a process group is initialized, else
0; it is resolved at the first record, never at import.
"""

from __future__ import annotations

import logging
import os
import sys

AVAILABLE_LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class _LazyProcFormatter(logging.Formatter):
    """Reads the process index when a record is formatted: a process group
    initialized after import is seen."""

    def format(self, record):
        import torch.distributed as dist

        record.proc = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        return super().format(record)


def _make_logger() -> logging.Logger:
    level_name = os.environ.get(
        "PACE_TPU_LOGLEVEL", os.environ.get("PACE_LOGLEVEL", "info")
    ).lower()
    level = AVAILABLE_LOG_LEVELS.get(level_name, logging.INFO)
    logger = logging.getLogger("pace_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            _LazyProcFormatter(
                fmt="%(asctime)s|%(levelname)s|proc %(proc)s|%(name)s:%(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


pace_log = _make_logger()


def set_log_level(level_name: str) -> None:
    pace_log.setLevel(AVAILABLE_LOG_LEVELS[level_name.lower()])


def get_logger() -> logging.Logger:
    return pace_log
