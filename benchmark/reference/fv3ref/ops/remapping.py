"""Lagrangian -> Eulerian vertical remapping (PPM, conservative).

Port of ``pace_tpu.ops.remapping`` (reference roles:
``pyFV3.stencils.remapping.LagrangianToEulerian`` with ``map_single`` /
``mapn_tracer``; savepoint stage ``Remapping``).

The remap evaluates the cumulative PPM integral at the target interfaces

    Q(p) = Q1[m] + dp1[m] * F_m((p - pe1[m]) / dp1[m]),   m = cell containing p

with ``Q1`` the running column integral at the source interfaces and ``m``
located by counting the source interfaces at or above ``p``, limited to
``D_OFFSET`` cells from the target's own index. It conserves the column
integral exactly: Q(pe_bottom) = sum q dp by construction, and the target
means are differences of Q.

:func:`remap_field` is the plain PyTorch version. Where the formulas divide by a number, the plain version
divides by a 0-dim tensor: PyTorch turns a division by a Python number on a
CUDA tensor into a multiplication by its reciprocal.
"""

from __future__ import annotations

import torch

from .ppm import _al_limited, _al_unlimited, _monotone_limit, _overshoot_limit, _positive_limit
from .stencil_utils import (
    scalar_like,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)

#: largest displacement, in cells, between a target interface's index and
#: the source cell that holds it
D_OFFSET = 5


def _k_index(q):
    """The level index along axis -3, shaped to broadcast against ``q``."""
    return torch.arange(q.shape[-3], device=q.device).reshape(-1, 1, 1)


def _noise_mask(q, shift, loose: bool):
    """Cells whose reconstruction must be monotonized: grid-scale extrema
    that are not smooth (curvature changes sign nearby). Smooth extrema keep
    the unlimited parabola. ``loose`` (kord 10) additionally requires an
    adjacent extremum. The two edge cells at each column end are always
    constrained (the shifts wrap there)."""
    dqm = q - shift(q, -1)
    dqp = shift(q, 1) - q
    ext = dqm * dqp <= 0.0
    d2 = dqp - dqm
    smooth = (d2 * shift(d2, -1) > 0.0) & (d2 * shift(d2, 1) > 0.0)
    mask = ext & ~smooth
    if loose:
        mask = mask & (shift(ext, -1) | shift(ext, 1))
    K = q.shape[-3]
    idx = _k_index(q)
    return mask | (idx <= 1) | (idx >= K - 2)


def _one_sided_edges(q, bl, br, clamp: bool = False):
    """Replace the wrap-contaminated interface estimates at the column ends
    with one-sided cubic reconstructions (exact for quadratic profiles);
    ``clamp`` bounds them by the adjacent cell means (the strictly monotone
    schemes). Columns of fewer than 3 cells are flattened at the edges."""
    K = q.shape[-3]
    if K < 3:
        idx = _k_index(q)
        edge = (idx <= 1) | (idx >= K - 2)
        zero = torch.zeros_like(bl)
        return torch.where(edge, zero, bl), torch.where(edge, zero, br)
    six = scalar_like(6.0, q)
    q0 = q[..., 0:1, :, :]
    q1 = q[..., 1:2, :, :]
    q2 = q[..., 2:3, :, :]
    qm1 = q[..., K - 1 : K, :, :]
    qm2 = q[..., K - 2 : K - 1, :, :]
    qm3 = q[..., K - 3 : K - 2, :, :]
    al0 = (11.0 * q0 - 7.0 * q1 + 2.0 * q2) / six  # top interface
    al1 = (2.0 * q0 + 5.0 * q1 - q2) / six  # interface between cells 0, 1
    alK = (11.0 * qm1 - 7.0 * qm2 + 2.0 * qm3) / six  # bottom interface
    alK1 = (2.0 * qm1 + 5.0 * qm2 - qm3) / six  # between cells K-2, K-1
    if clamp:
        lo01, hi01 = torch.minimum(q0, q1), torch.maximum(q0, q1)
        loK, hiK = torch.minimum(qm1, qm2), torch.maximum(qm1, qm2)
        al0 = torch.clamp(al0, lo01, hi01)
        al1 = torch.clamp(al1, lo01, hi01)
        alK = torch.clamp(alK, loK, hiK)
        alK1 = torch.clamp(alK1, loK, hiK)
    bl = torch.cat([al0 - q0, al1 - q1, bl[..., 2 : K - 1, :, :], alK1 - qm1], dim=-3)
    br = torch.cat([al1 - q0, br[..., 1 : K - 2, :, :], alK1 - qm2, alK - qm1], dim=-3)
    return bl, br


def vertical_reconstruction(q, kord: int, shift):
    """``(bl, br)`` interface perturbations along k for one remap scheme
    (the ``pace_tpu`` family; ``shift(a, n)[k] == a[k+n]``, wrapping):

    - ``|kord| <= 6``: limited interface values and the full CW84 monotone
      constraint (most diffusive, strictly monotone);
    - ``|kord| == 7``: limited interfaces and overshoot corrections only,
      the two edge cells at each end fully constrained;
    - ``|kord| == 8``: limited interfaces and selective monotonization (the
      noise mask);
    - ``|kord| == 9``: unlimited cubic interfaces, clamped to the stencil's
      range widened by that range, and selective monotonization;
    - ``|kord| >= 10``: as 9 with the looser (adjacent-extremum) trigger;
    - ``kord < 0``: the positive-definite constraint on top.
    """
    akord = abs(int(kord))
    if akord <= 8:
        al = _al_limited(q, shift)
    else:
        al = _al_unlimited(q, shift)
        # runaway guard: the interface value may overshoot the range of the
        # 4-cell stencil it reads by at most that range
        qm2, qm1, qp1 = shift(q, -2), shift(q, -1), shift(q, 1)
        lo = torch.minimum(torch.minimum(q, qm1), torch.minimum(qm2, qp1))
        hi = torch.maximum(torch.maximum(q, qm1), torch.maximum(qm2, qp1))
        r = hi - lo
        al = torch.clamp(al, lo - r, hi + r)
    bl = al - q
    br = shift(al, 1) - q
    bl, br = _one_sided_edges(q, bl, br, clamp=akord <= 8)
    if akord <= 6:
        bl, br = _monotone_limit(q, bl, br)
    elif akord == 7:
        blm, brm = _monotone_limit(q, bl, br)
        blo, bro = _overshoot_limit(bl, br)
        K = q.shape[-3]
        idx = _k_index(q)
        edge = (idx <= 1) | (idx >= K - 2)
        bl = torch.where(edge, blm, blo)
        br = torch.where(edge, brm, bro)
    else:  # 8, 9, 10+: selective
        blm, brm = _monotone_limit(q, bl, br)
        blo, bro = _overshoot_limit(bl, br)
        sel = _noise_mask(q, shift, loose=akord >= 10)
        bl = torch.where(sel, blm, blo)
        br = torch.where(sel, brm, bro)
    if kord < 0:
        bl, br = _positive_limit(q, bl, br)
    return bl, br


def _coerce_kord(kord) -> int:
    """Boolean ``monotone`` flags map to the scheme they meant (True -> kord
    4, False -> kord 9)."""
    if isinstance(kord, bool):
        return 4 if kord else 9
    return int(kord)


def _vertical_perturbations(q, kord):
    """bl/br perturbations along the K axis (axis -3)."""

    def shift(a, n):
        return torch.roll(a, -n, dims=-3)

    return vertical_reconstruction(q, _coerce_kord(kord), shift)


def source_cells(pe1, pe2):
    """Index along k of the source cell that each target interface's
    integral is evaluated in: ``m`` = the number of source interfaces
    1..K at or above the target pressure, clipped to the cells, then held
    within ``D_OFFSET`` of ``base = clip(j - 1, 0, K - 1)``; the index is
    ``clip(j - 1 + clip(m - base, -D, D), 0, K - 1)``. Shape of ``pe2``."""
    K = pe1.shape[-3] - 1
    K2 = pe2.shape[-3]
    pe1_bot = pe1[..., 1:, :, :]
    m = 0
    for c in range(0, K, 16):  # comparison counting in chunks of 16 levels
        sl = pe1_bot[..., c : c + 16, :, :]
        m = m + (sl.unsqueeze(-3) <= pe2.unsqueeze(-4)).sum(dim=-4)
    m = torch.clamp(m, 0, K - 1)
    j = torch.arange(K2, device=pe2.device).reshape(-1, 1, 1)
    base = torch.clamp(j - 1, 0, K - 1)
    off = torch.clamp(m - base, -D_OFFSET, D_OFFSET)
    return torch.clamp(j - 1 + off, 0, K - 1)


def remap_field(q, pe1, pe2, kord=4, monotone=None):
    """Conservatively remap layer means ``q`` from source interfaces ``pe1``
    to target interfaces ``pe2`` with the ``kord`` reconstruction scheme
    (see :func:`vertical_reconstruction`; a boolean ``monotone`` maps True
    -> kord 4, False -> kord 9).

    ``q``: (.., K, Y, X); ``pe1, pe2``: (.., K+1, Y, X) broadcastable
    against it, monotone increasing in k, with ``pe1[0] == pe2[0]`` and
    ``pe1[K] == pe2[K]`` (same column mass). Returns the target layer means
    (.., K2-1, Y, X).
    """
    if monotone is not None:
        kord = _coerce_kord(monotone)
    dp1 = pe1[..., 1:, :, :] - pe1[..., :-1, :, :]
    bl, br = _vertical_perturbations(q, kord)
    a_l = q + bl
    d_a = br - bl
    a6 = -3.0 * (bl + br)
    q_dp = q * dp1
    # running column integral at source interfaces: Q1[k] = sum_{m<k} q dp
    Q1 = torch.cat([torch.zeros_like(q_dp[..., :1, :, :]), torch.cumsum(q_dp, dim=-3)], dim=-3)

    # the bracketing cell's coefficients: exact copies, selected by index
    idx = source_cells(pe1, pe2)
    shape = torch.broadcast_shapes(q.shape[:-3] + idx.shape[-3:], idx.shape)
    idx = idx.expand(shape)

    def at(val):
        return torch.gather(val.expand(shape[:-3] + val.shape[-3:]), -3, idx)

    pe1_m = at(pe1[..., :-1, :, :])
    dp1_m = at(dp1)
    al_m, da_m, a6_m, Q1_m = at(a_l), at(d_a), at(a6), at(Q1[..., :-1, :, :])
    t = torch.clamp((pe2 - pe1_m) / dp1_m, 0.0, 1.0)
    f = al_m * t + 0.5 * da_m * t**2 + a6_m * (0.5 * t**2 - t**3 / scalar_like(3.0, t))
    q_int = Q1_m + dp1_m * f
    dq = q_int[..., 1:, :, :] - q_int[..., :-1, :, :]
    dp2 = pe2[..., 1:, :, :] - pe2[..., :-1, :, :]
    return dq / dp2


def remap_tracers(q, pe1, pe2, kord=4):
    """Remap a stacked tracer block ``(S, nq, K, Y, X)`` on the shared
    columns ``pe1, pe2 (S, K+1, Y, X)``: :func:`remap_field` one tracer at a
    time, as ``pace_tpu`` maps it over the tracers."""
    return torch.stack([remap_field(q[:, n], pe1, pe2, kord) for n in range(q.shape[1])], dim=1)


def pe_at_u_points(pe):
    """Interface pressures averaged to D-grid u points (y-interfaces).
    (.., K+1, Y, X) -> (.., K+1, Y+1, X)."""
    return 0.5 * (y_cell_to_left_iface(pe) + y_cell_to_right_iface(pe))


def pe_at_v_points(pe):
    """(.., K+1, Y, X) -> (.., K+1, Y, X+1)."""
    return 0.5 * (x_cell_to_left_iface(pe) + x_cell_to_right_iface(pe))
