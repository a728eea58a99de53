"""D-grid -> A-grid -> C-grid wind staggering transforms.

Port of ``pace_tpu.ops.d2a2c`` (reference role:
``pyFV3.stencils.d2a2c_vect``). Produces, from the prognostic D-grid
covariant winds:

- ``ua, va``: contravariant winds at cell centers (used for upwinding and as
  the advecting wind in several places),
- ``uc, vc``: covariant C-grid winds (x-wind at x-interfaces, y-wind at
  y-interfaces),
- ``ut, vt``: their contravariant counterparts.

4th-order interpolation uses the uniform (9/16, -1/16) weights everywhere:
halo ghost values are exact neighbor-tile values along continued index lines
(see pace_tpu_torch.parallel.topology), so no one-sided edge variants are
required.

:func:`d2a2c_plain` is the plain PyTorch version; :func:`d2a2c_vect` sends
CUDA tensors to the fused kernel (``ops/d2a2c_kernel.py``).
"""

from __future__ import annotations

import torch

from ._dispatch import route
from .fxadv import contravariant_c_winds
from .stencil_utils import (
    bcast_k,
    sx,
    sy,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)

A1 = 9.0 / 16.0
A2 = -1.0 / 16.0

#: the GridData fields the transforms read, in the kernel's argument order
GRID_FIELDS = (
    "rsin2", "cosa_s", "band_c", "cosa_u", "rsin_u2", "cosa_v", "rsin_v2",
    "ec1", "ec2", "ew1", "ew2", "es1", "es2", "minv",
)


def u_to_centers(u):
    """4th-order average of a y-interface field to cell centers along y.
    (.., Y+1, X) -> (.., Y, X)."""
    u_j = u[..., :-1, :]
    u_jp1 = u[..., 1:, :]
    u_jm1 = sy(u, -1)[..., :-1, :]
    u_jp2 = sy(u, 2)[..., :-1, :]
    return A1 * (u_j + u_jp1) + A2 * (u_jm1 + u_jp2)


def v_to_centers(v):
    """(.., Y, X+1) -> (.., Y, X) along x."""
    v_i = v[..., :-1]
    v_ip1 = v[..., 1:]
    v_im1 = sx(v, -1)[..., :-1]
    v_ip2 = sx(v, 2)[..., :-1]
    return A1 * (v_i + v_ip1) + A2 * (v_im1 + v_ip2)


def centers_to_x_ifaces(q):
    """4th-order interpolation of a center field to x-interfaces.
    (.., Y, X) -> (.., Y, X+1); interface ii between cells ii-1, ii."""
    q_m1 = x_cell_to_left_iface(q)
    q_0 = x_cell_to_right_iface(q)
    q_m2 = x_cell_to_left_iface(sx(q, -1))
    q_p1 = x_cell_to_right_iface(sx(q, 1))
    return A1 * (q_m1 + q_0) + A2 * (q_m2 + q_p1)


def centers_to_y_ifaces(q):
    """(.., Y, X) -> (.., Y+1, X)."""
    q_m1 = y_cell_to_left_iface(q)
    q_0 = y_cell_to_right_iface(q)
    q_m2 = y_cell_to_left_iface(sy(q, -1))
    q_p1 = y_cell_to_right_iface(sy(q, 1))
    return A1 * (q_m1 + q_0) + A2 * (q_m2 + q_p1)


def _dot3(a, b):
    """Sum over the component axis (-3) of a * b, components in order."""
    p = a * b
    return (p[..., 0, :, :] + p[..., 1, :, :]) + p[..., 2, :, :]


def cartesian_wind_centers(u, v, grid):
    """Physical wind as a Cartesian 3-vector at cell centers (.., 3, Y, X).

    Interior: 4th-order covariant averages of the D-grid winds, converted to
    contravariant and expanded in the local basis. Within 2 cells of a tile
    edge (where the 4-point stencils cross the basis kink and the covariant
    samples JUMP in value): a per-cell least-squares reconstruction from the
    cell's own four staggered covariant samples with their exact per-point
    bases (precomputed inverse normal matrix ``grid.minv``) — uniformly
    2nd-order and kink-proof.
    """
    utmp = u_to_centers(u)  # covariant x-wind at centers (4th order)
    vtmp = v_to_centers(v)
    rsin2 = bcast_k(grid.rsin2, utmp)
    cosa_s = bcast_k(grid.cosa_s, utmp)
    ua4 = (utmp - vtmp * cosa_s) * rsin2  # contravariant
    va4 = (vtmp - utmp * cosa_s) * rsin2
    ua4_e = ua4.unsqueeze(-3)
    va4_e = va4.unsqueeze(-3)
    v4 = ua4_e * bcast_k(grid.ec1, ua4_e) + va4_e * bcast_k(grid.ec2, va4_e)

    # local solve: b = sum_k sample_k * basis_k over the 4 cell faces
    u_e = u.unsqueeze(-3)  # (.., 1, Y+1, X)
    v_e = v.unsqueeze(-3)
    ue = u_e * bcast_k(grid.es1, u_e)
    ve = v_e * bcast_k(grid.ew2, v_e)
    b = ue[..., :-1, :] + ue[..., 1:, :] + ve[..., :, :-1] + ve[..., :, 1:]  # (.., 3, Y, X)
    v2 = None
    for jcomp in range(3):
        bj = b[..., jcomp, :, :].unsqueeze(-3)
        term = bcast_k(grid.minv[:, :, jcomp], bj) * bj
        v2 = term if v2 is None else v2 + term

    band = bcast_k(grid.band_c, v4) > 0.5
    return torch.where(band, v2, v4)


def d2a2c_plain(u, v, grid):
    """Plain PyTorch version of all staggering transforms from the D-grid
    winds ``u (.., Y+1, X)``, ``v (.., Y, X+1)``.

    Returns (ua, va, uc, vc, ut, vt). All interpolation to interfaces happens
    on the Cartesian wind vector (value-continuous across tile edges), then
    projects onto the local interface bases. Shifts wrap and pads replicate
    the edge, so the outermost three rings of every output are unspecified.
    """
    vcart = cartesian_wind_centers(u, v, grid)

    u_cov = _dot3(vcart, bcast_k(grid.ec1, vcart))
    v_cov = _dot3(vcart, bcast_k(grid.ec2, vcart))
    rsin2 = bcast_k(grid.rsin2, u_cov)
    cosa_s = bcast_k(grid.cosa_s, u_cov)
    ua = (u_cov - v_cov * cosa_s) * rsin2  # contravariant at centers
    va = (v_cov - u_cov * cosa_s) * rsin2

    vcart_x = centers_to_x_ifaces(vcart)  # (.., 3, Y, X+1)
    uc = _dot3(vcart_x, bcast_k(grid.ew1, vcart_x))
    vcart_y = centers_to_y_ifaces(vcart)  # (.., 3, Y+1, X)
    vc = _dot3(vcart_y, bcast_k(grid.es2, vcart_y))

    ut, vt = contravariant_c_winds(uc, vc, grid)
    return ua, va, uc, vc, ut, vt


def d2a2c_vect(u, v, grid):
    """(ua, va, uc, vc, ut, vt) from the D-grid winds: the fused CUDA kernel
    for 4-D ``(S, K, ·, ·)`` CUDA tensors, the plain version for CPU tensors.
    The two agree where a consumer reads them: ``ua, va`` everywhere, ``uc,
    vc`` on all but the outer two rings, ``ut, vt`` on all but the outer three."""
    if route(u, v, *(getattr(grid, f) for f in GRID_FIELDS)) == "kernel":
        from .d2a2c_kernel import d2a2c_cuda

        return d2a2c_cuda(u, v, grid)
    return d2a2c_plain(u, v, grid)
