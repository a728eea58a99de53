"""The lower-boundary selection of the physics.

Port of ``pace_tpu.models.shield.surface``'s configuration only. The
interactive surfaces (the NOAH-style LSM, the sea-ice slab and their blend)
are not ported yet (ROADMAP queue 1 item 5): :class:`~.physics.Physics`
refuses a ``type`` other than ``"none"``, the prescribed constant fluxes of
the PBL and convection configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SurfaceConfig:
    """Lower-boundary selection, ``pace_tpu``'s fields and defaults.

    ``type``: ``none`` (prescribed constant fluxes, the default), ``land``,
    ``seaice`` or ``mixed``.
    """

    type: str = "none"
    lsm: Optional[dict] = None      #: LSMConfig field overrides
    seaice: Optional[dict] = None   #: SeaIceConfig field overrides
    #: for type "mixed": land where |lat| <= land_lat_max [deg]
    land_lat_max: float = 55.0
    t_init: float = 288.0           #: initial skin/soil temperature [K]
    smc_init: float = 0.25          #: initial soil moisture [m^3/m^3]
    h_ice_init: float = 1.0         #: initial ice thickness [m]
    #: downward radiation used when gray_radiation is not in the scheme list:
    sw_dn: float = 340.0            #: [W/m^2]
    lw_dn: float = 330.0            #: [W/m^2]
