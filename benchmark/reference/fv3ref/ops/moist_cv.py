"""Moist heat capacities and condensate loading.

Port of ``pace_tpu.ops.moist_cv`` (reference role:
``pyFV3/stencils/moist_cv.py``). Per grid cell, the moist specific heats

    cvm = (1 - (qv + q_con)) * CV_AIR + qv * CV_VAPOR + q_liq * C_LIQ
          + q_sol * C_ICE
    cpm = (1 - (qv + q_con)) * CP_AIR + qv * CP_VAPOR + q_liq * C_LIQ
          + q_sol * C_ICE

with the liquid/solid split set by ``nwat``, the number of prognostic water
species. Elementwise functions of the stacked tracer block ``q (S, nq, K,
Y, X)``, tracer axis indexed by ``TRACER_NAMES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import constants
from ..constants import TRACER_NAMES

_IV = TRACER_NAMES.index("qvapor")
_IL = TRACER_NAMES.index("qliquid")
_II = TRACER_NAMES.index("qice")
_IR = TRACER_NAMES.index("qrain")
_IS = TRACER_NAMES.index("qsnow")
_IG = TRACER_NAMES.index("qgraupel")


def water_species(q, nwat: int = 6):
    """``(qv, q_liq, q_sol)`` of the tracer block for ``nwat``: 6 -> liquid
    qliquid + qrain, solid qice + qsnow + qgraupel; 3 -> qliquid, qice; 2 ->
    qliquid, no solid; 1 or 0 -> vapor only or dry."""
    zeros = torch.zeros_like(q[:, 0])
    qv = q[:, _IV] if nwat >= 1 else zeros
    if nwat >= 6:
        q_liq = q[:, _IL] + q[:, _IR]
        q_sol = q[:, _II] + q[:, _IS] + q[:, _IG]
    elif nwat >= 3:
        q_liq = q[:, _IL]
        q_sol = q[:, _II]
    elif nwat == 2:
        q_liq = q[:, _IL]
        q_sol = zeros
    else:
        q_liq = zeros
        q_sol = zeros
    return qv, q_liq, q_sol


def compute_q_con(q, nwat: int = 6):
    """Total condensate loading ``q_con = q_liq + q_sol``."""
    _, q_liq, q_sol = water_species(q, nwat)
    return q_liq + q_sol


def moist_cv(q, nwat: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cvm, q_con)``: moist heat capacity at constant volume [J/kg/K]."""
    qv, q_liq, q_sol = water_species(q, nwat)
    q_con = q_liq + q_sol
    cvm = (
        (1.0 - (qv + q_con)) * constants.CV_AIR
        + qv * constants.CV_VAPOR
        + q_liq * constants.C_LIQ
        + q_sol * constants.C_ICE
    )
    return cvm, q_con


def moist_cp(q, nwat: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cpm, q_con)``: moist heat capacity at constant pressure [J/kg/K]."""
    qv, q_liq, q_sol = water_species(q, nwat)
    q_con = q_liq + q_sol
    cpm = (
        (1.0 - (qv + q_con)) * constants.CP_AIR
        + qv * constants.CP_VAPOR
        + q_liq * constants.C_LIQ
        + q_sol * constants.C_ICE
    )
    return cpm, q_con
