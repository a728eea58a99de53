"""Shared mass-flux transport discretization of the convection and EDMF
schemes.

Port of ``pace_tpu.models.shield.mf_common``. The environment tendency of a
plume-transported variable is applied in flux form, dX/dt = g * d/dp [ M *
(X_u - X_env) ], on interfaces: the updraft value from the layer below each
interface, the environment value from the layer above (compensating
subsidence). Any interface mass-flux profile that vanishes at the top and
bottom conserves the column integral of X to roundoff.

Index convention: k increases downward; layer k sits between interfaces k
(top) and k+1 (bottom); the k axis is at position -3.
"""

from __future__ import annotations

import torch

from ... import constants


def cbrt(x):
    """Cube root of a non-negative tensor (the convective velocity scale w*
    of the PBL and SAS closures; PyTorch has no ``cbrt``)."""
    return torch.pow(x, 1.0 / 3.0)


def hydrostatic_heights(tv, pe):
    """Heights above the surface from hydrostatic integration of log-p.

    ``tv`` virtual temperature (.., K, Y, X), ``pe`` interface pressure
    (.., K+1, Y, X). Returns (z_mid, z_if, dz), in meters, dz > 0.
    """
    peln = torch.log(pe)
    dz = constants.RDGAS * tv / constants.GRAV * (peln[..., 1:, :, :] - peln[..., :-1, :, :])
    z_top_if = torch.flip(torch.cumsum(torch.flip(dz, dims=(-3,)), dim=-3), dims=(-3,))
    z_if = torch.cat([z_top_if, torch.zeros_like(z_top_if[..., :1, :, :])], dim=-3)
    z_mid = 0.5 * (z_if[..., :-1, :, :] + z_if[..., 1:, :, :])
    return z_mid, z_if, dz


def flux_form_divergence(m_if, x_u, x_env, delp):
    """Tendency g * d/dp [ M (x_u - x_env) ] per layer.

    ``m_if`` interface mass flux (.., K+1, Y, X), positive upward, zero at
    interfaces 0 and K for conservation; ``x_u``/``x_env`` layer fields;
    ``delp`` layer pressure thickness.
    """
    # interface i <- layer i (below); i=K has no layer below but M=0 there
    xu_if = torch.cat([x_u, x_u[..., -1:, :, :]], dim=-3)
    # interface i <- layer i-1 (above); i=0 has none but M=0 there
    xe_if = torch.cat([x_env[..., :1, :, :], x_env], dim=-3)
    f = m_if * (xu_if - xe_if)
    return constants.GRAV * (f[..., 1:, :, :] - f[..., :-1, :, :]) / delp
