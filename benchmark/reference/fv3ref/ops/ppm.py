"""1-D PPM (piecewise parabolic method) interface reconstruction and fluxes.

Port of ``pace_tpu.ops.ppm`` (reference role: ``pyFV3.stencils.xppm`` /
``yppm``, hord 5/6/7/8 variants). Everything is branchless ``torch.where``
selects on whole tensors. The CUDA transport kernel
(``csrc/fvtp2d.cu``) repeats this arithmetic op for op.

Index convention: cell ``i`` spans chart interval ``[i, i+1)``; interface
index ``i`` is the boundary between cells ``i-1`` and ``i``. Courant numbers
are in cell (index) units, positive toward +axis. The returned interface
value ``f`` is the mean of the reconstructed upstream profile over the
swept interval; the physical flux is ``f * (area flux)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencil_utils import scalar_like, sx, sy

#: hord values accepted (reference namelist hord_mt/hord_vt/hord_tm/hord_dp/hord_tr)
SUPPORTED_HORDS = (1, 5, 6, 7, 8)


def _al_unlimited(q, shift):
    """4th-order interface interpolation: al[i] estimates q at interface i."""
    return (7.0 / 12.0) * (shift(q, -1) + q) - (1.0 / 12.0) * (
        shift(q, -2) + shift(q, 1)
    )


def _limited_slope(q, shift):
    """Van Leer / CW84 limited slope per cell: bounds al within neighbors."""
    dm = 0.5 * (shift(q, 1) - shift(q, -1))
    dq_r = shift(q, 1) - q
    dq_l = q - shift(q, -1)
    mono = dq_r * dq_l > 0.0
    lim = torch.minimum(torch.abs(dm), 2.0 * torch.minimum(torch.abs(dq_r), torch.abs(dq_l)))
    return torch.where(mono, torch.sign(dm) * lim, torch.zeros_like(lim))


def _al_limited(q, shift):
    """CW84 interface interpolation from limited slopes: al_i in
    [min, max](q_{i-1}, q_i). The division by 6 is by a 0-dim tensor
    (:func:`scalar_like`)."""
    dm = _limited_slope(q, shift)
    return 0.5 * (shift(q, -1) + q) + (shift(dm, -1) - dm) / scalar_like(6.0, q)


def _overshoot_limit(bl, br):
    """CW84 parabola overshoot corrections on interface perturbations (bl =
    aL - q, br = aR - q), without extremum flattening: a parabola that
    overshoots right gets bl = -2 br, one that overshoots left br = -2 bl."""
    da = br - bl
    a6 = -3.0 * (bl + br)
    over_r = da * a6 > da * da
    over_l = -(da * da) > da * a6
    bl2 = torch.where(over_r, -2.0 * br, bl)
    br2 = torch.where(over_l & ~over_r, -2.0 * bl, br)
    return bl2, br2


def _monotone_limit(q, bl, br):
    """Colella-Woodward monotonicity constraint: :func:`_overshoot_limit`,
    and a local extremum (bl*br >= 0) flattened to a constant."""
    bl2, br2 = _overshoot_limit(bl, br)
    extremum = bl * br >= 0.0
    zero = torch.zeros_like(bl)
    return torch.where(extremum, zero, bl2), torch.where(extremum, zero, br2)


def _dm_mono(q, shift):
    """Mono limited slope: the centered slope clamped to the distance from
    the cell mean to the local 3-cell extremes, with sign transfer."""
    qp = shift(q, 1)
    qm = shift(q, -1)
    xt = 0.5 * (qp - qm)
    q_hi = torch.maximum(torch.maximum(qm, q), qp) - q
    q_lo = q - torch.minimum(torch.minimum(qm, q), qp)
    lim = torch.minimum(torch.abs(xt), torch.minimum(q_hi, q_lo))
    return torch.where(xt >= 0.0, lim, -lim)


def _perturbations_mono(q, shift):
    """hord=8 monotone interface perturbations, dm-clamp formulation: the
    slope-limited interpolant is clamped so |b| <= 2|dm| with the slope's
    sign."""
    dm = _dm_mono(q, shift)
    al = 0.5 * (shift(q, -1) + q) + (1.0 / 3.0) * (shift(dm, -1) - dm)
    xt2 = 2.0 * dm
    axt = torch.abs(xt2)
    blm = torch.minimum(axt, torch.abs(al - q))
    brm = torch.minimum(axt, torch.abs(shift(al, 1) - q))
    bl = torch.where(xt2 >= 0.0, -blm, blm)
    br = torch.where(xt2 >= 0.0, brm, -brm)
    return bl, br


def _positive_limit(q, bl, br):
    """Positive-definite constraint (Lin 2004 'iv=0' style): the cell
    parabola stays >= 0 where the input mean is >= 0, touching only cells
    whose parabola undershoots zero."""

    def vertex_min(bl_, br_, aL_):
        da_ = br_ - bl_
        a6_ = -3.0 * (bl_ + br_)
        has_vertex = torch.abs(da_) < torch.abs(a6_)
        safe_a6 = torch.where(a6_ == 0.0, torch.full_like(a6_, 1e-30), a6_)
        p_vertex = aL_ + (da_ + a6_) ** 2 / (4.0 * safe_a6)
        return torch.where(has_vertex, p_vertex, aL_)

    aL = q + bl
    aR = q + br
    p_min = torch.minimum(torch.minimum(aL, aR), vertex_min(bl, br, aL))
    need = p_min < 0.0
    bl1 = torch.maximum(bl, -q)
    br1 = torch.maximum(br, -q)
    still_neg = vertex_min(bl1, br1, q + bl1) < 0.0
    zero = torch.zeros_like(bl1)
    bl1 = torch.where(still_neg, zero, bl1)
    br1 = torch.where(still_neg, zero, br1)
    return torch.where(need, bl1, bl), torch.where(need, br1, br)


def _perturbations(q, hord: int, shift):
    if hord == 8:
        return _perturbations_mono(q, shift)
    al = _al_unlimited(q, shift)
    bl = al - q
    br = shift(al, 1) - q
    if hord in (5, 6):
        pass  # unlimited
    elif hord == 7:
        bl, br = _positive_limit(q, bl, br)
    else:
        raise ValueError(f"unsupported hord {hord}; choose from {SUPPORTED_HORDS}")
    return bl, br


def _flux_1d(q, c, hord: int, shift):
    """Interface value of the upstream PPM profile mean, along one axis.
    ``c[..., i]`` belongs to the interface between cells i-1 and i."""
    if hord == 1:  # first-order upwind
        return torch.where(c > 0.0, shift(q, -1), q)
    bl, br = _perturbations(q, hord, shift)
    b0 = bl + br
    # upstream cell i-1 (c > 0): mean over [1-c, 1] of its parabola
    f_pos = shift(q, -1) + (1.0 - c) * (shift(br, -1) - c * shift(b0, -1))
    # upstream cell i (c < 0): mean over [0, |c|]
    f_neg = q + (1.0 + c) * (bl + c * b0)
    return torch.where(c > 0.0, f_pos, f_neg)


def xppm(q, crx, hord: int):
    """PPM interface values along x; q and crx share their shape."""
    return _flux_1d(q, crx, hord, sx)


def yppm(q, cry, hord: int):
    """PPM interface values along y (interface j between cells j-1, j)."""
    return _flux_1d(q, cry, hord, sy)


def xppm_i(q, crx, hord: int):
    """As xppm for staggered storage: q (..., Y, X), crx (..., Y, X+1)."""
    return _flux_1d(F.pad(q, (0, 1)), crx, hord, sx)


def yppm_i(q, cry, hord: int):
    """As yppm with cry: (..., Y+1, X)."""
    return _flux_1d(F.pad(q, (0, 0, 0, 1)), cry, hord, sy)
