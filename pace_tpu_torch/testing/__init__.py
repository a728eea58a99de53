"""Validation/testing machinery: stage checkpointers, threshold calibration,
round-off perturbation, the sanitizer and the translate framework (port of
``pace_tpu.testing``; reference roles: ``ndsl.checkpointer`` and
``ndsl.testing``)."""

from .checkpointer import (  # noqa: F401
    PairStageComparator,
    SavepointThresholds,
    SnapshotCheckpointer,
    Threshold,
    ThresholdCalibrationCheckpointer,
    ValidationCheckpointer,
    ValidationError,
)
from .perturb import perturb  # noqa: F401
from .sanitizer import SanitizerCheckpointer, SanitizerError  # noqa: F401
from .validation import (  # noqa: F401
    SelectiveValidationCheckpointer,
    ValidationRegion,
    get_region,
)
