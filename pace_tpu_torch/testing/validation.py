"""Selective validation: restrict comparisons to the variable regions a
module actually computes.

Port of ``pace_tpu.testing.validation`` (reference role:
``pyFV3.testing.validation``: "Selective validation masks not-validated
array regions with NaN"). Before comparing, every output array has its
not-computed regions (halo bands, unused interface rows/columns) overwritten
with NaN — differences there cannot fail a test and cannot silently pass as
agreement either.

The masks are plain utilities that compose with the stage checkpointers
(:mod:`pace_tpu_torch.testing.checkpointer`): a ``ValidationRegion`` names,
per variable, the region that is validated; the
``SelectiveValidationCheckpointer`` applies it before delegating.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .checkpointer import _concrete


@dataclasses.dataclass(frozen=True)
class ValidationRegion:
    """Which part of a (S, [K,] Y, X) stacked field is validated.

    ``halo``: number of ghost cells to EXCLUDE from the trailing (Y, X) axes.
    ``y_extra``/``x_extra``: extra valid rows/cols beyond the compute domain
    (1 for interface-staggered variables, 0 for centers).
    """

    halo: int = 3
    y_extra: int = 0
    x_extra: int = 0

    def mask(self, arr: np.ndarray) -> np.ndarray:
        """Copy of ``arr`` with not-validated regions set to NaN."""
        out = np.array(arr, dtype=float, copy=True)
        h = self.halo
        if h <= 0:
            return out
        nan = float("nan")
        Y, X = out.shape[-2], out.shape[-1]
        out[..., :h, :] = nan
        out[..., Y - h + self.y_extra:, :] = nan
        out[..., :, :h] = nan
        out[..., :, X - h + self.x_extra:] = nan
        return out


def cell_center_region(halo: int = 3) -> ValidationRegion:
    return ValidationRegion(halo=halo)


def x_interface_region(halo: int = 3) -> ValidationRegion:
    return ValidationRegion(halo=halo, x_extra=1)


def y_interface_region(halo: int = 3) -> ValidationRegion:
    return ValidationRegion(halo=halo, y_extra=1)


#: default per-variable regions for the dycore state (D-grid staggering:
#: u is a y-interface field, v an x-interface field; uc the reverse)
DEFAULT_REGIONS: Dict[str, ValidationRegion] = {
    "u": y_interface_region(),
    "v": x_interface_region(),
    "uc": x_interface_region(),
    "vc": y_interface_region(),
    "mfx": x_interface_region(),
    "mfy": y_interface_region(),
}


def get_region(name: str, halo: int = 3) -> ValidationRegion:
    """Region for a variable name (interface staggering where known)."""
    reg = DEFAULT_REGIONS.get(name)
    if reg is not None and reg.halo == halo:
        return reg
    if reg is not None:
        return ValidationRegion(halo, reg.y_extra, reg.x_extra)
    return cell_center_region(halo)


class SelectiveValidationCheckpointer:
    """Wrap a checkpointer so every array is NaN-masked outside its validated
    region before recording/comparison (reference enable_selective_validation
    analog). Pass ``regions`` to override per-variable regions."""

    def __init__(self, inner, regions: Optional[Dict[str, ValidationRegion]] = None,
                 halo: int = 3):
        self._inner = inner
        self._regions = regions or {}
        self._halo = halo

    def _region(self, name: str) -> ValidationRegion:
        return self._regions.get(name) or get_region(name, self._halo)

    def __call__(self, stage: str, **variables):
        masked = {
            name: self._region(name).mask(_concrete(arr))
            for name, arr in variables.items()
        }
        return self._inner(stage, **masked)

    def __getattr__(self, item):
        return getattr(self._inner, item)
