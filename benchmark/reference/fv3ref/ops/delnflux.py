"""Del-n hyperdiffusion fluxes (2nd/4th/6th/8th order damping).

Port of ``pace_tpu.ops.delnflux`` (reference role: ``pyFV3.stencils.delnflux``:
2Δx divergence damping + del-n hyperdiffusion fluxes; params nord, d2_bg,
d4_bg, dddmp). Returns damping fluxes in the same q*m^2 units as the
advective fvtp2d fluxes so callers simply add them before the divergence
update.

``nord`` Laplacian iterations give (2(nord+1))-order damping: nord=0 is del-2,
nord=1 del-4, nord=2 del-6. The damping coefficient is supplied nondimensional
(``damp_c`` ~ reference d2_bg/d4_bg) and scaled internally by the appropriate
power of the minimum cell area, following the reference convention
(damp = (damp_c * da_min)^(nord+1)).

Plain PyTorch, as in ``pace_tpu`` (these operators have no fused kernel of
their own; the D-grid tail kernel iterates its corner Laplacian itself).
"""

from __future__ import annotations

from .stencil_utils import (
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    x_iface_diff,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
    y_iface_diff,
)


def _grad_fluxes(q, grid):
    """Down-gradient fluxes of a cell field: fx(ii) ~ q(ii-1) - q(ii)."""
    wx = bcast_k(grid.sina_u * grid.dy * grid.rdxc, q[..., :1])
    fx = (x_cell_to_left_iface(q) - x_cell_to_right_iface(q)) * wx
    wy = bcast_k(grid.sina_v * grid.dx * grid.rdyc, q[..., :1, :])
    fy = (y_cell_to_left_iface(q) - y_cell_to_right_iface(q)) * wy
    return fx, fy


def delnflux(q, grid, nord: int, damp_c: float, da_min: float):
    """Damping fluxes (fx, fy) for a cell-centered field ``q``.

    The sign convention ensures the resulting update
    ``q += (x_iface_diff(fx) + y_iface_diff(fy)) * rarea`` damps q for any
    nord: each Laplacian iteration flips sign, compensated here.
    """
    # Overflow-safe factoring of damp = (damp_c*da_min)^(nord+1): fold one
    # factor of da_min into every Laplacian iteration (rarea*da_min <= 1) so
    # all intermediates stay O(q) — (damp_c*da_min)^4 alone overflows f32 at
    # production resolutions (da_min ~ 1e11 m^2 at C24).
    d2 = q
    fx, fy = _grad_fluxes(d2, grid)
    for _ in range(nord):
        # d2 <- -Laplacian-like of previous (area-normalized divergence)
        d2 = (
            -(x_iface_diff(fx) + y_iface_diff(fy))
            * bcast_k(grid.rarea, fx[..., :-1])
            * da_min
        )
        fx, fy = _grad_fluxes(d2, grid)
    damp = damp_c ** (nord + 1) * da_min
    return damp * fx, damp * fy


def lap_corner_weights(grid, divg_weights: bool = False):
    """Gradient weights ``(wgx (S, Y+1, X), wgy (S, Y, X+1))`` of
    :func:`lap_corner`: transverse dual length over edge length, or the
    sina-carrying ``divg_u/divg_v`` metric arrays."""
    if divg_weights:
        return grid.divg_u(), grid.divg_v()
    return grid.rdx * grid.dyc, grid.rdy * grid.dxc


def lap_corner(q, grid, divg_weights: bool = False):
    """Laplacian-like operator for corner-registered fields (dual mesh),
    used to iterate divergence damping to higher order.

    q: (.., Y+1, X+1). Differences along primal edge directions between
    adjacent corners (sitting at the staggered wind points), weighted by the
    crossing dual-face length over edge length; divergence back onto corners.

    ``divg_weights=True`` weights the gradients with the reference's
    sina-carrying divg_u/divg_v metric arrays (one-sided supergrid sines
    on tile-edge lines, GridData.divg_u/divg_v), the formulation the
    reference's divergence_damping iterates; gated by
    DSWConfig.lap_divg_weights.
    """
    # gx[..., k] connects corners k -> k+1 (at the u point (jj, k)); weight
    # = transverse dual length dyc / edge length dx
    wgx, wgy = lap_corner_weights(grid, divg_weights)
    gx = q[..., :, 1:] - q[..., :, :-1]  # (.., Y+1, X)
    gx = gx * bcast_k(wgx, gx)
    gy = q[..., 1:, :] - q[..., :-1, :]  # (.., Y, X+1)
    gy = gy * bcast_k(wgy, gy)
    lap = (
        x_cell_to_right_iface(gx)
        - x_cell_to_left_iface(gx)
        + y_cell_to_right_iface(gy)
        - y_cell_to_left_iface(gy)
    )
    return lap * bcast_k(grid.rarea_c, lap)
