"""Hybrid sigma-pressure vertical coordinate: ak/bk coefficients.

Analog of the reference's eta-file machinery (``GeneratedGridConfig.eta_file``
pointing at an ak/bk netCDF; failure modes tested in reference
tests/main/grid/test_eta.py). Interface pressures are
``pe(k) = ak(k) + bk(k) * ps``. Two sources:

- :func:`from_file` — reads ak/bk from a (classic-format) netCDF file with
  variables ``ak``/``bk`` (the FV3 ``fv_core.res.nc`` layout also works).
- :func:`analytic_hybrid` — generates a smooth hybrid coordinate for any npz:
  pure-pressure levels above ``p_transition``, smoothly blending to terrain-
  following sigma at the surface. This replaces the reference's hard-coded
  per-npz tables (the submodule's ``set_eta``) with a closed-form recipe.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import P_REF


@dataclasses.dataclass(frozen=True)
class HybridPressureCoefficients:
    ak: np.ndarray  # (npz+1,), Pa
    bk: np.ndarray  # (npz+1,), dimensionless

    @property
    def npz(self) -> int:
        return len(self.ak) - 1

    @property
    def ptop(self) -> float:
        return float(self.ak[0])

    def pressure_interfaces(self, ps) -> np.ndarray:
        ps = np.asarray(ps)
        return self.ak.reshape((-1,) + (1,) * ps.ndim) + np.multiply.outer(
            self.bk, ps
        )

    def validate(self) -> None:
        if self.bk[0] != 0.0:
            raise ValueError("bk[0] must be 0 (pure pressure at model top)")
        if abs(self.bk[-1] - 1.0) > 1e-12:
            raise ValueError("bk[-1] must be 1 (sigma at the surface)")
        pe = self.pressure_interfaces(np.array([40000.0, 101325.0]))
        if not (np.diff(pe, axis=0) > 0).all():
            raise ValueError("interface pressures must increase monotonically")


def analytic_hybrid(
    npz: int,
    ptop: float = 100.0,
    p_transition: float = 10000.0,
    p0: float = P_REF,
    ps_min: float = 40000.0,
    stretch: float = 1.15,
) -> HybridPressureCoefficients:
    """Smooth hybrid coordinate, monotone by construction for all ps >= ps_min.

    Built from two monotone interface-pressure profiles: ``pe_hi`` at surface
    pressure ``p0`` (log-spaced top, stretched bottom) and ``pe_lo`` at
    ``ps_min`` (identical above ``p_transition`` — pure pressure levels — and
    quadratically compressed below). Solving ``ak + bk*p`` through both
    profiles makes every ps in [ps_min, ∞) a monotone blend.
    """
    if npz < 3:
        raise ValueError("npz must be >= 3")
    if not (ptop < p_transition < ps_min < p0):
        raise ValueError("need ptop < p_transition < ps_min < p0")
    k = np.arange(npz + 1, dtype=np.float64) / npz
    log_top = np.log(ptop)
    log_bot = np.log(p0)
    w = k**stretch
    pe_hi = np.exp(log_top + (log_bot - log_top) * np.sin(0.5 * np.pi * w))
    pe_hi[0] = ptop
    pe_hi[-1] = p0
    u = np.clip((pe_hi - p_transition) / (p0 - p_transition), 0.0, 1.0)
    pe_lo = np.where(
        pe_hi <= p_transition,
        pe_hi,
        p_transition + (ps_min - p_transition) * u**2,
    )
    pe_lo[-1] = ps_min
    bk = (pe_hi - pe_lo) / (p0 - ps_min)
    bk[0] = 0.0
    bk[-1] = 1.0
    ak = pe_hi - bk * p0
    ak[-1] = 0.0
    coeffs = HybridPressureCoefficients(ak=ak, bk=bk)
    coeffs.validate()
    return coeffs


def from_file(path: str) -> HybridPressureCoefficients:
    """Load ak/bk from a classic netCDF file (variables ``ak`` and ``bk``)."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as ds:
        if "ak" not in ds.variables or "bk" not in ds.variables:
            raise ValueError(f"{path} does not contain 'ak' and 'bk' variables")
        ak = np.array(ds.variables["ak"][:], dtype=np.float64).reshape(-1)
        bk = np.array(ds.variables["bk"][:], dtype=np.float64).reshape(-1)
    if ak.shape != bk.shape:
        raise ValueError(f"ak shape {ak.shape} != bk shape {bk.shape}")
    coeffs = HybridPressureCoefficients(ak=ak, bk=bk)
    coeffs.validate()
    return coeffs


def get_coefficients(
    npz: int, eta_file: str | None = None, **analytic_kwargs
) -> HybridPressureCoefficients:
    if eta_file is not None:
        coeffs = from_file(eta_file)
        if coeffs.npz != npz:
            raise ValueError(
                f"eta file {eta_file} has npz={coeffs.npz}, expected {npz}"
            )
        return coeffs
    return analytic_hybrid(npz, **analytic_kwargs)
