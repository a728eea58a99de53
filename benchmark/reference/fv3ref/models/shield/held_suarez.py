"""Held-Suarez (1994) idealized forcing.

Port of ``pace_tpu.models.shield.held_suarez``: Newtonian relaxation of
temperature toward the Held & Suarez (1994, BAMS) equilibrium profile and
Rayleigh drag on the low-level winds, the canonical dry-dynamical-core
climate test. Both relaxations are implicit (x / (1 + dt k)).
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants
from .radiation import sin_latitude


@dataclasses.dataclass(frozen=True)
class HeldSuarezConfig:
    """HS94 constants (their eq. 1-4): ``pace_tpu``'s fields and defaults."""

    t_strat: float = 200.0      #: stratospheric floor [K]
    t_eq_sfc: float = 315.0     #: equatorial surface equilibrium T [K]
    delta_t_y: float = 60.0     #: equator-pole contrast [K]
    delta_theta_z: float = 10.0 #: static-stability parameter [K]
    sigma_b: float = 0.7        #: boundary-layer top in sigma
    k_a: float = 1.0 / (40.0 * 86400.0)  #: free-atmosphere relaxation [1/s]
    k_s: float = 1.0 / (4.0 * 86400.0)   #: surface relaxation [1/s]
    k_f: float = 1.0 / 86400.0           #: Rayleigh friction [1/s]


def equilibrium_temperature(p_mid, sinlat2, cfg: HeldSuarezConfig):
    """T_eq(phi, p) of HS94 eq. (3)."""
    pref = p_mid / constants.P_REF
    coslat2 = 1.0 - sinlat2
    t_eq = (
        cfg.t_eq_sfc
        - cfg.delta_t_y * sinlat2
        - cfg.delta_theta_z * torch.log(pref) * coslat2
    ) * pref**constants.KAPPA
    return torch.clamp(t_eq, min=cfg.t_strat)


def _sigma_factor(p_mid, ps, cfg):
    sig = p_mid / ps.unsqueeze(-3)
    return torch.clamp((sig - cfg.sigma_b) / (1.0 - cfg.sigma_b), min=0.0)


def _to_y_iface(a):
    """(.., Y, X) -> (.., Y+1, X): the average of neighbours, the edges
    clamped to the outer rows."""
    mid = 0.5 * (a[..., :-1, :] + a[..., 1:, :])
    return torch.cat([a[..., :1, :], mid, a[..., -1:, :]], dim=-2)


def _to_x_iface(a):
    mid = 0.5 * (a[..., :-1] + a[..., 1:])
    return torch.cat([a[..., :1], mid, a[..., -1:]], dim=-1)


def held_suarez_step(u, v, pt, pkz, p_mid, ps, f0, dt: float, cfg: HeldSuarezConfig):
    """One forcing step on the dycore's fields; returns new (u, v, pt).

    ``pt`` is (virtual) potential temperature; HS94 is dry so T = pt*pkz.
    ``f0`` (S, Y, X), the Coriolis parameter at centers, gives sin(lat).
    The D-grid winds are damped on their own points (Rayleigh drag scales a
    vector, so covariant components damp by the same factor), the damping
    coefficient averaged onto each staggering with edge clamping.
    """
    sinlat = sin_latitude(f0)
    sinlat2 = (sinlat * sinlat).unsqueeze(-3)
    coslat2 = 1.0 - sinlat2

    # --- temperature relaxation (implicit)
    sigfac = _sigma_factor(p_mid, ps, cfg)
    k_t = cfg.k_a + (cfg.k_s - cfg.k_a) * sigfac * coslat2 * coslat2
    t = pt * pkz
    t_eq = equilibrium_temperature(p_mid, sinlat2, cfg)
    t_new = (t + dt * k_t * t_eq) / (1.0 + dt * k_t)
    pt_new = t_new / pkz

    # --- Rayleigh friction below sigma_b (implicit)
    k_v = cfg.k_f * sigfac  # (S, K, Y, X) at centers
    u_new = u / (1.0 + dt * _to_y_iface(k_v))
    v_new = v / (1.0 + dt * _to_x_iface(k_v))
    return u_new, v_new, pt_new
