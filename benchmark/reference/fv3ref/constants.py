"""Physical constants and dimension-name conventions.

Analog of ``ndsl.constants`` (reference usage: driver/pace/driver/driver.py:21,
README.md:91-95).  The constant *set* is selectable via the ``PACE_TPU_CONSTANTS``
environment variable (GFDL | GFS | GEOS), mirroring the reference's ``PACE_CONSTANTS``.
"""

from __future__ import annotations

import dataclasses
import os

# ----------------------------------------------------------------------------
# Dimension-name conventions (reference: ndsl.constants dim names, used at
# driver/pace/driver/state.py:11 and tests/mpi_54rank/test_external_grid.py:16)
# ----------------------------------------------------------------------------
X_DIM = "x"
X_INTERFACE_DIM = "x_interface"
Y_DIM = "y"
Y_INTERFACE_DIM = "y_interface"
Z_DIM = "z"
Z_INTERFACE_DIM = "z_interface"
TILE_DIM = "tile"

HORIZONTAL_DIMS = (X_DIM, X_INTERFACE_DIM, Y_DIM, Y_INTERFACE_DIM)
INTERFACE_DIMS = (X_INTERFACE_DIM, Y_INTERFACE_DIM, Z_INTERFACE_DIM)

#: Number of ghost/halo cells on each side of the compute domain.
N_HALO_DEFAULT = 3

#: Number of tiles of a cubed sphere.
N_TILES = 6

#: Number of distinct edges of the cube (each shared by exactly 2 tiles).
N_CUBE_EDGES = 12


@dataclasses.dataclass(frozen=True)
class ConstantSet:
    """One named set of physical constants."""

    name: str
    #: radius of Earth [m]
    RADIUS: float
    #: gravitational acceleration [m/s^2]
    GRAV: float
    #: gas constant of dry air [J/kg/K]
    RDGAS: float
    #: gas constant of water vapor [J/kg/K]
    RVGAS: float
    #: specific heat of dry air at constant pressure [J/kg/K]
    CP_AIR: float
    #: latent heat of vaporization [J/kg]
    HLV: float
    #: latent heat of fusion [J/kg]
    HLF: float
    #: rotation rate of Earth [1/s]
    OMEGA: float

    @property
    def KAPPA(self) -> float:
        return self.RDGAS / self.CP_AIR

    @property
    def CV_AIR(self) -> float:
        return self.CP_AIR - self.RDGAS

    @property
    def ZVIR(self) -> float:
        return self.RVGAS / self.RDGAS - 1.0

    @property
    def RGRAV(self) -> float:
        return 1.0 / self.GRAV

    @property
    def CP_VAPOR(self) -> float:
        return 4.0 * self.RVGAS

    @property
    def CV_VAPOR(self) -> float:
        return 3.0 * self.RVGAS


_CONSTANT_SETS = {
    "GFDL": ConstantSet(
        name="GFDL",
        RADIUS=6371.0e3,
        GRAV=9.80,
        RDGAS=287.04,
        RVGAS=461.50,
        CP_AIR=1004.6,
        HLV=2.500e6,
        HLF=3.34e5,
        OMEGA=7.292e-5,
    ),
    "GFS": ConstantSet(
        name="GFS",
        RADIUS=6.3712e6,
        GRAV=9.80665,
        RDGAS=287.05,
        RVGAS=461.50,
        CP_AIR=1004.6,
        HLV=2.5e6,
        HLF=3.3358e5,
        OMEGA=7.2921e-5,
    ),
    "GEOS": ConstantSet(
        name="GEOS",
        RADIUS=6371.0e3,
        GRAV=9.80665,
        RDGAS=287.04,
        RVGAS=461.50,
        CP_AIR=1004.16,
        HLV=2.4665e6,
        HLF=3.3370e5,
        OMEGA=2.0 * 3.141592653589793 / 86164.0,
    ),
}


def get_constants(name: str | None = None) -> ConstantSet:
    """Return the selected constant set (default from ``PACE_TPU_CONSTANTS`` env)."""
    if name is None:
        name = os.environ.get(
            "PACE_TPU_CONSTANTS", os.environ.get("PACE_CONSTANTS", "GFDL")
        )
    try:
        return _CONSTANT_SETS[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown constants set {name!r}; choose from {sorted(_CONSTANT_SETS)}"
        )


# Module-level default set, frozen at import time (like the reference).
CONST = get_constants()

PI = 3.14159265358979323846
RADIUS = CONST.RADIUS
GRAV = CONST.GRAV
RGRAV = CONST.RGRAV
RDGAS = CONST.RDGAS
RVGAS = CONST.RVGAS
CP_AIR = CONST.CP_AIR
CV_AIR = CONST.CV_AIR
KAPPA = CONST.KAPPA
ZVIR = CONST.ZVIR
HLV = CONST.HLV
HLF = CONST.HLF
OMEGA = CONST.OMEGA
CP_VAPOR = CONST.CP_VAPOR
CV_VAPOR = CONST.CV_VAPOR
#: specific heat of liquid water [J/kg/K]
C_LIQ = 4185.5
#: specific heat of ice [J/kg/K]
C_ICE = 1972.0
#: reference surface pressure [Pa]
P_REF = 1.0e5
#: freezing temperature [K]
TICE = 273.16
#: minimum sea-level pressure sanity bound [Pa]
SFC_PRES_MIN = 40000.0

#: the dycore's tracer registry, in the order of the stacked tracer axis
#: (reference driver/pace/driver/state.py restart comment)
TRACER_NAMES = (
    "qvapor",
    "qliquid",
    "qice",
    "qrain",
    "qsnow",
    "qgraupel",
    "qo3mr",
    "qsgs_tke",
    "qcld",
)
