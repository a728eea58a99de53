"""The moist tracer block of the program's ``demos/physics_step.moist_tracers``,
made on the device: vapor uniform in ``vapor_fraction`` of the saturation
mixing ratio at each point's dry temperature ``pt * pkz`` and mid-layer
pressure (capped at ``qsat_max``), each condensate uniform in
``[0, condensate_max[name]]``, every other tracer uniform in
``[other_low, other_high]``; halos included. So condensation, evaporation,
the ice processes and sedimentation all act in the first physics call.

The saturation fit is the program's (Flatau-style, liquid), copied:
``es = 611.21 exp(17.502 tc / (tc + 240.97))``, ``tc = T - 273.16`` clipped
to [-80, 50], ``qsat = eps es / max(p - es, 1)``, ``eps = 287.04 / 461.50``.
"""

from __future__ import annotations

import dataclasses

import torch

#: the tracer axis's order (the program's ``constants.TRACER_NAMES``)
TRACER_NAMES = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel", "qo3mr",
                "qsgs_tke", "qcld")
T_FREEZE = 273.16
EPS = 287.04 / 461.50


def saturation_mixing_ratio(t, p):
    tc = torch.clamp(t - T_FREEZE, -80.0, 50.0)
    es = 611.21 * torch.exp(17.502 * tc / (tc + 240.97))
    return EPS * es / torch.clamp(p - es, min=1.0)


def apply(state, params, draws, n_halo):
    q = state.q
    if q.shape[1] != len(TRACER_NAMES):
        raise ValueError(f"the moist recipe fills {len(TRACER_NAMES)} tracers, the state has "
                         f"{q.shape[1]}")
    p_mid = 0.5 * (state.pe[:, 1:] + state.pe[:, :-1])
    qsat = torch.clamp(saturation_mixing_ratio(state.pt * state.pkz, p_mid),
                       max=float(params["qsat_max"]))
    u = draws.rand(q.shape, q)
    lo, hi = params["vapor_fraction"]
    cmax = params["condensate_max"]
    out = torch.empty_like(q)
    for i, name in enumerate(TRACER_NAMES):
        if name == "qvapor":
            out[:, i] = qsat * (lo + (hi - lo) * u[:, i])
        elif name in cmax:
            out[:, i] = float(cmax[name]) * u[:, i]
        else:
            a, b = float(params["other_low"]), float(params["other_high"])
            out[:, i] = a + (b - a) * u[:, i]
    return dataclasses.replace(state, q=out)
