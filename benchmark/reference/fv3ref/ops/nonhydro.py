"""Nonhydrostatic vertical dynamics: the semi-implicit Riemann solvers and
the interface-height chains of both halves of the acoustic substep.

Port of ``pace_tpu.ops.nonhydro`` (reference roles:
``pyFV3.stencils.{riem_solver_c, riem_solver3, sim1_solver, updatedzc,
updatedzd, nh_p_grad}``).

Formulation (backward-Euler limit a_imp=1):

- Unknowns: interface vertical velocities W_k (k=0..K; W_K = ws at the
  surface). Layer gas-law pressure linearized in thickness:
      p_k^+ = p_k + B_k (W_{k+1} - W_k) dt,  B_k = -gamma p_k / dz_k > 0
- Interface momentum (dm_hat = half-sum of adjacent layer masses):
      W_k^+ = W_k + (dt/dm_hat_k)(p'_k^+ - p'_{k-1}^+)
  which closes into a diagonally dominant tridiagonal system.
- Layer w and delz follow from the solved interface field; the perturbation
  interface pressure feeds the pressure-gradient force.

Every operator here is the program's plain PyTorch version (the program
also has CUDA kernels for :func:`heights_from_delz`, :func:`updatedz_c`,
:func:`flux_height_update`, the solve of :func:`sim1_solve` and
:func:`nh_p_grad`).

Where the formulas divide by a number (``/ GRAV``, ``dt /``, ``/ dt2``) the
plain versions divide by a 0-dim tensor (``stencil_utils.scalar_like``): PyTorch turns a
division by a Python number on a CUDA tensor into a multiplication by its
reciprocal, which rounds differently from the IEEE division that the kernels,
the CPU and ``pace_tpu`` perform.
"""

from __future__ import annotations

import torch

from .. import constants
from .pgrad import _pgf_pair, a2b_ord4
from .stencil_utils import (
    bcast_k,
    scalar_like,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    x_iface_diff,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
    y_iface_diff,
)
from .fvtp2d import fvtp2d

GAMMA = 1.0 / (1.0 - constants.KAPPA)  # cp/cv


def _shift_down(t: torch.Tensor) -> torch.Tensor:
    """``t`` one level down along k with a zero top level: out[k] = t[k-1]."""
    return torch.cat([torch.zeros_like(t[..., :1, :, :]), t[..., :-1, :, :]], dim=-3)


def tridiagonal_solve(a, b, c, d):
    """Thomas algorithm along axis -3, vectorized over the other axes.

    a: sub-diagonal (a[0] unused), b: diagonal, c: super-diagonal (c[-1]
    unused), d: rhs. All (.., K, Y, X). Returns x with b x + a x_(k-1) +
    c x_(k+1) = d. A Python loop over k on whole planes: the plain version of
    the solve, not meant to be fast.
    """
    K = d.shape[-3]
    zeros = torch.zeros_like(d[..., 0, :, :])
    cp_k, dp_k = zeros, zeros
    cp, dp = [], []
    for k in range(K):
        a_k = a[..., k, :, :]
        denom = b[..., k, :, :] - a_k * cp_k
        cp_k = c[..., k, :, :] / denom
        dp_k = (d[..., k, :, :] - a_k * dp_k) / denom
        cp.append(cp_k)
        dp.append(dp_k)
    x_k = zeros
    xs = [None] * K
    for k in range(K - 1, -1, -1):
        x_k = dp[k] - cp[k] * x_k
        xs[k] = x_k
    return torch.stack(xs, dim=-3)


def _interface_mass_weighted(dm, wl):
    """Layer field -> interior interfaces (k=1..K-1), mass-weighted.
    dm, wl: (.., K, Y, X) -> (.., K-1, Y, X)."""
    dm_up = dm[..., :-1, :, :]
    dm_dn = dm[..., 1:, :, :]
    return (dm_dn * wl[..., :-1, :, :] + dm_up * wl[..., 1:, :, :]) / (dm_up + dm_dn)


def _hydrostatic_layer_pressure(delp, ptop: float):
    """The log-mean layer pressure ``delp / d(ln pe)`` of the hydrostatic
    interface pressures ``pe = ptop + cumsum(delp)``. For a hydrostatically
    balanced column the gas-law pressure equals exactly this."""
    pe_below = ptop + torch.cumsum(delp, dim=-3)
    pe = torch.cat([torch.full_like(pe_below[..., :1, :, :], ptop), pe_below], dim=-3)
    peln = torch.log(torch.clamp(pe, min=1e-10))
    return delp / (peln[..., 1:, :, :] - peln[..., :-1, :, :])


def sim1_solver(w, delz, pt, delp, pkz, ws, dt: float, ptop: float = 0.0,
                a_imp: float = 1.0):
    """Semi-implicit vertical solve (reference sim1_solver analog).

    Inputs are layer tensors (.., K, Y, X): w [m/s], delz [m, negative],
    pt (theta_v [K]), delp [Pa], pkz (layer-mean (p/P_REF)^kappa), and
    ``ws`` (.., Y, X) the surface vertical velocity (terrain-following BC).

    ``a_imp`` is the implicitness weight θ of the reference's riem_solver
    family: the pressure and velocity updates are evaluated at the θ-blended
    time level,
        p'^+ = p'^0 + B (θ ΔW^+ + (1-θ) ΔW^0)
        W^+  = W^0 + r [θ (δp'^+) + (1-θ) (δp'^0)]
    which closes into the same tridiagonal with the implicit coupling scaled
    by θ² and an explicit divergence term on the rhs; θ=1 is the
    backward-Euler limit, θ=0.5 the trapezoidal scheme.

    Returns (w_new, delz_new, pp_interfaces) with ``pp`` the perturbation
    interface pressure [Pa] (pp[0] = 0 at the model top).
    """
    theta = float(a_imp)
    dm = delp / scalar_like(constants.GRAV, delp)
    dt_t = scalar_like(dt, delp)

    # full gas-law layer pressure: rho = dm / (-delz), T_v = pt * pkz,
    # p = rho Rd Tv; pprime vanishes at hydrostatic equilibrium
    t_v = pt * pkz
    p_full = dm * constants.RDGAS * t_v / (-delz)
    pprime = p_full - _hydrostatic_layer_pressure(delp, ptop)

    b_coef = -GAMMA * p_full * dt / delz  # B_k > 0 (delz < 0)

    # interface masses (top interface uses half the first layer)
    dm_hat_int = 0.5 * (dm[..., :-1, :, :] + dm[..., 1:, :, :])  # k=1..K-1
    dm_hat_top = 0.5 * dm[..., :1, :, :]

    # initial interface velocities (mass-weighted), top = w0, bottom = ws
    w_int = _interface_mass_weighted(dm, w)  # k=1..K-1
    w_top = w[..., :1, :, :]

    # --- assemble the tridiagonal for W_k, k=0..K-1 (W_K = ws Dirichlet)
    # row k: -(dt B_{k-1}/dmh_k) W_{k-1} + [1 + (dt/dmh_k)(B_{k-1}+B_k)] W_k
    #        -(dt B_k/dmh_k) W_{k+1} = W_k0 + (dt/dmh_k)(p'_k0 - p'_{k-1,0})
    dmh = torch.cat([dm_hat_top, dm_hat_int], dim=-3)  # k=0..K-1
    b_km1 = _shift_down(b_coef)  # B_{k-1}, zero for k=0 (no layer above)
    r = dt_t / dmh
    th2 = theta * theta
    a_diag = -th2 * r * b_km1
    b_diag = 1.0 + th2 * r * (b_km1 + b_coef)
    c_diag = -th2 * r * b_coef
    w0 = torch.cat([w_top, w_int], dim=-3)
    ws_e = ws.unsqueeze(-3) if ws.ndim == w.ndim - 1 else ws
    rhs = w0 + r * (pprime - _shift_down(pprime))
    if theta != 1.0:
        # explicit part of the blended divergence: θ(1-θ) r δ(B ΔW^0)
        w0_full = torch.cat([w0, ws_e], dim=-3)
        dwdz0 = w0_full[..., 1:, :, :] - w0_full[..., :-1, :, :]
        bdw0 = b_coef * dwdz0
        rhs = rhs + theta * (1.0 - theta) * r * (bdw0 - _shift_down(bdw0))
    # fold the known W_K = ws into the last row's rhs
    rhs = torch.cat(
        [rhs[..., :-1, :, :], rhs[..., -1:, :, :] + (-c_diag[..., -1:, :, :] * ws_e)], dim=-3
    )
    c_diag = torch.cat(
        [c_diag[..., :-1, :, :], torch.zeros_like(c_diag[..., -1:, :, :])], dim=-3
    )

    w_iface = tridiagonal_solve(a_diag, b_diag, c_diag, rhs)  # k=0..K-1
    w_iface_full = torch.cat([w_iface, ws_e], dim=-3)  # k=0..K

    # --- updates
    dwdz = w_iface_full[..., 1:, :, :] - w_iface_full[..., :-1, :, :]
    if theta != 1.0:
        # blended divergence drives the thickness/pressure updates
        dwdz = theta * dwdz + (1.0 - theta) * dwdz0
    delz_new = delz + dt * dwdz
    # B already carries the dt factor: delta p' = B * delta W
    pprime_new = pprime + b_coef * dwdz

    # perturbation pressure at interfaces for the PGF: pp[0]=0 (free top),
    # interior mass-weighted interpolation, bottom one-sided extrapolation
    pp_int = _interface_mass_weighted(dm, pprime_new)
    pp_bot = 1.5 * pprime_new[..., -1:, :, :] - 0.5 * pprime_new[..., -2:-1, :, :]
    pp = torch.cat([torch.zeros_like(pp_bot), pp_int, pp_bot], dim=-3)

    # layer w from interface pressure differences
    w_new = w + (dt_t / dm) * (pp[..., 1:, :, :] - pp[..., :-1, :, :])
    return w_new, delz_new, pp


def _p_fac_floor(delz_new, pt, delp, pkz, ptop, p_fac: float):
    """Pressure floor of the reference riem_solver family (p_fac namelist):
    the solver must not expand a layer so far that its gas-law pressure
    drops below ``p_fac`` × the hydrostatic layer pressure. Equivalent cap on
    the thickness:
        (-delz)_max = dm·Rd·Tv / (p_fac·p_hyd).
    """
    dm = delp / scalar_like(constants.GRAV, delp)
    t_v = pt * pkz
    limit = dm * constants.RDGAS * t_v / (p_fac * _hydrostatic_layer_pressure(delp, ptop))
    return torch.maximum(delz_new, -limit)


def sim1_solve(w, delz, pt, delp, pkz, ws, dt: float, ptop: float = 0.0,
               a_imp: float = 1.0, p_fac: float = 0.05):
    """:func:`sim1_solver`, then the ``p_fac`` floor of :func:`_p_fac_floor`
    (``p_fac <= 0`` skips it)."""
    w_new, delz_new, pp = sim1_solver(w, delz, pt, delp, pkz, ws, dt, ptop, a_imp=a_imp)
    if p_fac > 0.0:
        delz_new = _p_fac_floor(delz_new, pt, delp, pkz, ptop, p_fac)
    return w_new, delz_new, pp


def riem_solver3(w, delz, pt, delp, pkz, ws, dt: float, ptop: float = 0.0,
                 a_imp: float = 1.0, p_fac: float = 0.05):
    """D-grid vertical solve (reference riem_solver3)."""
    return sim1_solve(w, delz, pt, delp, pkz, ws, dt, ptop, a_imp=a_imp, p_fac=p_fac)


def riem_solver_c(w, delz, ptc, delpc, pkz, ws, dt2: float, ptop: float,
                  a_imp: float = 1.0, p_fac: float = 0.05):
    """C-grid provisional solve (reference riem_solver_c): returns the full
    nonhydrostatic interface pressure [Pa] for p_grad_c and the solved
    thicknesses."""
    _w_new, delz_new, pp = sim1_solve(
        w, delz, ptc, delpc, pkz, ws, dt2, ptop, a_imp=a_imp, p_fac=p_fac
    )
    pe_below = ptop + torch.cumsum(delpc, dim=-3)
    pe = torch.cat([torch.full_like(pe_below[..., :1, :, :], ptop), pe_below], dim=-3)
    return pe + pp, delz_new


def heights_from_delz(delz, phis):
    """Interface geopotential heights zh [m] integrated up from the surface.
    delz (.., K, Y, X) negative; phis (.., Y, X) surface geopotential."""
    zs = phis.unsqueeze(-3) / scalar_like(constants.GRAV, phis)
    csum = torch.flip(torch.cumsum(torch.flip(delz, dims=(-3,)), dim=-3), dims=(-3,))
    zh_top = zs - csum  # zh_k = zs - sum_{m>=k} delz_m (delz<0 => zh above zs)
    return torch.cat([zh_top, zs * torch.ones_like(delz[..., :1, :, :])], dim=-3)


def _to_iface(f):
    """Layer flux -> interfaces: the mean of the adjacent layers, the
    nearest layer at the top and the bottom."""
    mid = 0.5 * (f[..., :-1, :, :] + f[..., 1:, :, :])
    return torch.cat([f[..., :1, :, :], mid, f[..., -1:, :, :]], dim=-3)


def updatedz_c(zh_x, zh_y, xfx_l, yfx_l, grid, dt2: float):
    """C-grid interface-height update before riem_solver_c (reference
    updatedzc): the provisional C-grid solve must see heights advected by
    the same C-grid winds that advected delpc/ptc, plus the
    terrain-following surface velocity ws_c those heights imply.

    ``zh_x``/``zh_y``: interface heights (.., K+1, Y, X) with x/y corner
    folds; ``xfx_l``/``yfx_l``: the LAYER upwind area fluxes already
    computed by c_sw for the provisional delp/pt transport (``CGridState``
    ``.xfx``/``.yfx``; averaged to interfaces here). First-order upwind,
    matching that transport.

    Returns (zh_new, ws_c) with the bottom interface pinned back to the
    surface.
    """
    area = grid.area
    xfx, yfx = _to_iface(xfx_l), _to_iface(yfx_l)
    zx = torch.where(xfx > 0.0, x_cell_to_left_iface(zh_x), x_cell_to_right_iface(zh_x))
    zy = torch.where(yfx > 0.0, y_cell_to_left_iface(zh_y), y_cell_to_right_iface(zh_y))
    area_b = bcast_k(area, zh_x)
    ra = area_b + x_iface_diff(xfx) + y_iface_diff(yfx)
    zh_new = (zh_x * area_b + x_iface_diff(zx * xfx) + y_iface_diff(zy * yfx)) / ra
    zs = zh_x[..., -1:, :, :]
    ws_c = (zh_new[..., -1:, :, :] - zs)[..., 0, :, :] / scalar_like(dt2, zh_x)
    zh_new = torch.cat([zh_new[..., :-1, :, :], zs], dim=-3)
    return zh_new, ws_c


def flux_height_update(zh, fx, fy, xfx_i, yfx_i, area):
    """Flux-form update of the interface heights, ``(zh area + flux
    divergence) / (area + area-flux divergence)``; all operands
    interface-registered in k."""
    area_b = bcast_k(area, zh)
    ra = area_b + x_iface_diff(xfx_i) + y_iface_diff(yfx_i)
    return (zh * area_b + x_iface_diff(fx) + y_iface_diff(fy)) / ra


def updatedz_d(zh_x, zh_y, crx, cry, xfx, yfx, grid, dt: float, hord: int = 5):
    """Horizontal advection of interface heights by the layer winds
    (reference updatedzd). zh: (.., K+1, Y, X) with corner ghosts in x/y fold;
    courant/area fluxes are LAYER quantities, averaged to the interfaces from
    the adjacent layers (top/bottom use the nearest layer).

    Uses the same 2-D PPM transport as the mass fluxes so height surfaces and
    pressure surfaces move consistently (a first-order upwind here leaves
    O(upwind-diffusion) height errors that the implicit vertical solver turns
    into spurious w). Returns the advected zh; the caller enforces the
    surface BC and derives ws. (``dt`` is not used: the fluxes carry it.)"""
    crx_i, cry_i, xfx_i, yfx_i = (_to_iface(f) for f in (crx, cry, xfx, yfx))
    fl = fvtp2d(zh_x, zh_y, crx_i, cry_i, xfx_i, yfx_i, grid.area, hord)
    return flux_height_update(zh_x, fl.fx, fl.fy, xfx_i, yfx_i, grid.area)


def nh_p_grad(u, v, pk, gz, pp, delp, grid, dt: float):
    """Nonhydrostatic split-form D-grid pressure gradient (reference
    nh_p_grad): the hydrostatic ``pk`` contour plus the perturbation-pressure
    contour over ``delp``, each on corner values from :func:`a2b_ord4`.
    ``pk, gz, pp`` are interface fields ``(S, K+1, Y, X)``, ``delp`` a layer
    field; returns ``(u + du_h + du_p, v + dv_h + dv_p)``, summed in that
    order."""
    pk_b = a2b_ord4(pk, grid)
    gz_b = a2b_ord4(gz, grid)
    pp_b = a2b_ord4(pp, grid)
    delp_b = a2b_ord4(delp, grid)
    rdx = bcast_k(grid.rdx, u)
    rdy = bcast_k(grid.rdy, v)
    du_h = _pgf_pair(gz_b[..., :, :-1], gz_b[..., :, 1:], pk_b[..., :, :-1], pk_b[..., :, 1:],
                     dt, rdx)
    dv_h = _pgf_pair(gz_b[..., :-1, :], gz_b[..., 1:, :], pk_b[..., :-1, :], pk_b[..., 1:, :],
                     dt, rdy)

    def pert_pair(gz1, gz2, pp1, pp2, dp1, dp2, rdl):
        g1k, g1kp = gz1[..., :-1, :, :], gz1[..., 1:, :, :]
        g2k, g2kp = gz2[..., :-1, :, :], gz2[..., 1:, :, :]
        p1k, p1kp = pp1[..., :-1, :, :], pp1[..., 1:, :, :]
        p2k, p2kp = pp2[..., :-1, :, :], pp2[..., 1:, :, :]
        term = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k)
        return dt * rdl * term / (dp1 + dp2)

    du_p = pert_pair(gz_b[..., :, :-1], gz_b[..., :, 1:], pp_b[..., :, :-1], pp_b[..., :, 1:],
                     delp_b[..., :, :-1], delp_b[..., :, 1:], rdx)
    dv_p = pert_pair(gz_b[..., :-1, :], gz_b[..., 1:, :], pp_b[..., :-1, :], pp_b[..., 1:, :],
                     delp_b[..., :-1, :], delp_b[..., 1:, :], rdy)
    return u + du_h + du_p, v + dv_h + dv_p


