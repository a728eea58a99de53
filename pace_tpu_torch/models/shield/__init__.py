"""SHiELD physics (port of ``pace_tpu.models.shield``): ``Physics`` with
the GFDL microphysics, the EDMF PBL and SAS convection, the
``PHYSICS_PACKAGES`` registry and the dycore coupling."""

from .physics import PHYSICS_PACKAGES, Physics  # noqa: F401
