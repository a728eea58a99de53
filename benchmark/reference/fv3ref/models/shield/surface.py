"""The interactive lower boundary: couples the LSM and sea-ice schemes into
the physics.

Port of ``pace_tpu.models.shield.surface``. The surface scheme takes the
radiation's downward surface fluxes and the lowest model level's state, and
returns the kinematic sensible and latent heat fluxes that drive the EDMF
PBL and the SAS passes. The previous call's precipitation rate is carried
in the surface state (a one-call lag). All surface fields are dense
(S, Y, X) planes: the ghost columns compute harmlessly and are never read
back into the dycore's compute domain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...dtypes import resolve_device
from ...utils.registry import from_dict
from .lsm import LSMConfig, LSMState, lsm_step
from .radiation import sin_latitude
from .seaice import SeaIceConfig, SeaIceState, seaice_step


@dataclasses.dataclass(frozen=True)
class SurfaceConfig:
    """Lower-boundary selection, ``pace_tpu``'s fields and defaults.

    ``type``: ``none`` (prescribed constant fluxes from the PBL and SAS
    configs, the default), ``land`` (the LSM everywhere), ``seaice`` (the
    Semtner slab everywhere), or ``mixed`` (land equatorward of
    ``land_lat_max``, sea ice/ocean poleward: both schemes run on every
    column and their fluxes blend by the latitude mask).
    """

    type: str = "none"
    lsm: Optional[dict] = None      #: LSMConfig field overrides
    seaice: Optional[dict] = None   #: SeaIceConfig field overrides
    #: for type "mixed": land where |lat| <= land_lat_max [deg], sea
    #: ice/ocean poleward of it
    land_lat_max: float = 55.0
    t_init: float = 288.0           #: initial skin/soil temperature [K]
    smc_init: float = 0.25          #: initial soil moisture [m^3/m^3]
    h_ice_init: float = 1.0         #: initial ice thickness [m]
    #: downward radiation used when no radiation scheme is in the list:
    sw_dn: float = 340.0            #: [W/m^2]
    lw_dn: float = 330.0            #: [W/m^2]


@dataclasses.dataclass
class SurfaceState:
    """Carried surface state: ``lsm``, ``ice`` or both are populated (which,
    is fixed per Physics instance). ``precip`` is the previous call's
    surface precipitation rate [kg/m^2/s]."""

    precip: torch.Tensor
    lsm: Optional[LSMState] = None
    ice: Optional[SeaIceState] = None


@dataclasses.dataclass(frozen=True)
class SurfaceScheme:
    """The resolved surface scheme: construction, stepping and readout.

    Indexable as the tuple (cfg, init, step, tskin), as in ``pace_tpu``;
    ``diagnostics(sfc)`` returns the per-point diagnostic fields (for the
    mixed type, the inactive scheme's fields are NaN)."""

    cfg: object
    init: object      #: (shape, dtype, device) -> SurfaceState
    step: object      #: (forcing, SurfaceState, dt) -> (fluxes, SurfaceState)
    tskin: object     #: SurfaceState -> (.., Y, X) radiative skin temperature
    diagnostics: object  #: SurfaceState -> dict of (.., Y, X) fields

    def __iter__(self):
        return iter((self.cfg, self.init, self.step, self.tskin))

    def __getitem__(self, i):
        return (self.cfg, self.init, self.step, self.tskin)[i]


def _precip0(shape, dtype, device):
    return torch.zeros(tuple(shape), dtype=dtype, device=resolve_device(device))


def build_surface(cfg: SurfaceConfig, grid=None):
    """The SurfaceScheme of the configured type, or None for ``none``.
    ``grid`` (or a callable returning it) supplies the latitude, through
    the Coriolis parameter, for the ``mixed`` land mask."""
    if cfg.type == "none":
        return None
    if cfg.type == "mixed":
        return _build_mixed(cfg, grid)
    if cfg.type == "land":
        scheme_cfg = from_dict(LSMConfig, cfg.lsm or {})

        def init(shape, dtype, device="cuda"):
            return SurfaceState(
                precip=_precip0(shape, dtype, device),
                lsm=LSMState.init(shape, t0=cfg.t_init, smc0=cfg.smc_init, dtype=dtype,
                                  device=device),
            )

        def step(forcing, sfc: SurfaceState, dt):
            fluxes, new = lsm_step(**forcing, state=sfc.lsm, dt=dt, cfg=scheme_cfg)
            return fluxes, dataclasses.replace(sfc, lsm=new)

        def tskin(sfc: SurfaceState):
            return sfc.lsm.tskin

        def diagnostics(sfc: SurfaceState):
            return {
                "tskin": sfc.lsm.tskin,
                "snow_water_equivalent": sfc.lsm.sneqv,
                "soil_moisture": sfc.lsm.smc[..., 0, :, :],
            }

        return SurfaceScheme(scheme_cfg, init, step, tskin, diagnostics)
    if cfg.type == "seaice":
        scheme_cfg = from_dict(SeaIceConfig, cfg.seaice or {})

        def init(shape, dtype, device="cuda"):
            return SurfaceState(
                precip=_precip0(shape, dtype, device),
                ice=SeaIceState.init(shape, h0=cfg.h_ice_init, t0=cfg.t_init, dtype=dtype,
                                     device=device),
            )

        def step(forcing, sfc: SurfaceState, dt):
            fluxes, new = seaice_step(**forcing, state=sfc.ice, dt=dt, cfg=scheme_cfg)
            return fluxes, dataclasses.replace(sfc, ice=new)

        def tskin(sfc: SurfaceState):
            return sfc.ice.tsfc

        def diagnostics(sfc: SurfaceState):
            return {"tskin": sfc.ice.tsfc, "h_ice": sfc.ice.h_ice, "sst": sfc.ice.sst}

        return SurfaceScheme(scheme_cfg, init, step, tskin, diagnostics)
    raise ValueError(f"unknown surface type {cfg.type!r}; expected none|land|seaice|mixed")


def _build_mixed(cfg: SurfaceConfig, grid):
    """Earthlike blend: the LSM on the land mask, Semtner ice/ocean
    elsewhere. Both schemes run on every column; the fluxes and the
    radiative skin blend by the mask."""
    if grid is None:
        raise ValueError("surface type 'mixed' needs the grid (latitude mask)")
    lsm_cfg = from_dict(LSMConfig, cfg.lsm or {})
    ice_cfg = from_dict(SeaIceConfig, cfg.seaice or {})
    sin_max = float(np.sin(np.radians(cfg.land_lat_max)))

    def land_mask(like):
        # from the grid at call time (``grid`` may be a callable, so that a
        # caller who reassigns the physics' grid gets its latitudes)
        g = grid() if callable(grid) else grid
        return (sin_latitude(g.f0).abs() <= sin_max).expand(like.shape)

    def init(shape, dtype, device="cuda"):
        return SurfaceState(
            precip=_precip0(shape, dtype, device),
            lsm=LSMState.init(shape, t0=cfg.t_init, smc0=cfg.smc_init, dtype=dtype,
                              device=device),
            ice=SeaIceState.init(shape, h0=cfg.h_ice_init, t0=min(cfg.t_init, 271.0),
                                 dtype=dtype, device=device),
        )

    def step(forcing, sfc: SurfaceState, dt):
        fx_l, lsm_new = lsm_step(**forcing, state=sfc.lsm, dt=dt, cfg=lsm_cfg)
        fx_i, ice_new = seaice_step(**forcing, state=sfc.ice, dt=dt, cfg=ice_cfg)
        mask = land_mask(sfc.lsm.tskin)
        fluxes = {k: torch.where(mask, fx_l[k], fx_i[k]) for k in fx_l if k in fx_i}
        return fluxes, dataclasses.replace(sfc, lsm=lsm_new, ice=ice_new)

    def tskin(sfc: SurfaceState):
        return torch.where(land_mask(sfc.lsm.tskin), sfc.lsm.tskin, sfc.ice.tsfc)

    def diagnostics(sfc: SurfaceState):
        # the inactive scheme's state means nothing at a point: NaN
        mask = land_mask(sfc.lsm.tskin)
        return {
            "tskin": tskin(sfc),
            "snow_water_equivalent": torch.where(mask, sfc.lsm.sneqv, math.nan),
            "soil_moisture": torch.where(mask, sfc.lsm.smc[..., 0, :, :], math.nan),
            "h_ice": torch.where(mask, math.nan, sfc.ice.h_ice),
            "sst": torch.where(mask, math.nan, sfc.ice.sst),
        }

    return SurfaceScheme((lsm_cfg, ice_cfg), init, step, tskin, diagnostics)
