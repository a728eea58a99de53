"""Dycore auxiliary operators: sponge-layer diffusion, fast Rayleigh damping,
negative-tracer adjustment, the saturation adjustment, the total-energy
fixer.

Port of ``pace_tpu.ops.dycore_extras`` (reference roles: ``pyFV3.stencils.
{del2cubed, ray_fast, neg_adj3, fillz}`` and ``SatAdjust3d``:
upper-atmosphere sponge-layer Laplacian damping (n_sponge, d_ext); Rayleigh
damping of u, v, w above rf_cutoff; filling of negative tracers; the fast
saturation adjustment of ``do_sat_adj``, shared with the GFDL microphysics,
and the diagnostic cloud fraction; and the ``consv_te`` global energy fixer
of the Remapping stage). Plain PyTorch throughout, as ``pace_tpu`` leaves
them to XLA; ``fillz``'s column scans are loops over k.
"""

from __future__ import annotations

import math

import torch

from .. import constants
from ..parallel.mesh import all_reduce, get_shard_mesh
from ..constants import TRACER_NAMES
from ..models.shield.microphysics import (
    MicrophysicsConfig,
    fast_saturation_adjustment,
    saturation_mixing_ratio,
)
from .delnflux import _grad_fluxes
from .stencil_utils import (
    bcast_k,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    x_iface_diff,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
    y_iface_diff,
)


def del2cubed(q, grid, nmax: int, cd: float):
    """Horizontal Laplacian diffusion applied ``nmax`` times with coefficient
    ``cd`` (premultiplied by dt). Operates on the whole field; callers slice
    the top ``n_sponge`` layers."""
    for _ in range(nmax):
        fx, fy = _grad_fluxes(q, grid)
        q = q + cd * (x_iface_diff(fx) + y_iface_diff(fy)) * bcast_k(grid.rarea, q)
    return q


def apply_sponge(pt, u_or_none, grid, n_sponge: int, d_ext: float, dt: float):
    """Sponge diffusion of the top ``n_sponge`` layers of a cell field.
    ``d_ext`` is a nondimensional per-step diffusion number, clipped to the
    explicit Laplacian's stability bound; ``n_sponge <= 0`` or ``d_ext <= 0``
    returns ``pt`` itself."""
    if n_sponge <= 0 or d_ext <= 0.0:
        return pt
    cd = min(d_ext, 0.2) * grid.da_min
    top = del2cubed(pt[..., :n_sponge, :, :], grid, 2, cd)
    return torch.cat([top, pt[..., n_sponge:, :, :]], dim=-3)


def rayleigh_rate(p, ptop: float, rf_cutoff: float, tau: float):
    """Rayleigh friction rate [1/s] at pressure ``p``: zero below
    ``rf_cutoff`` [Pa], ramping as ``sin^2`` of the log-pressure distance to
    ``1/tau`` at the model top. Divisions are by tensors, as ``pace_tpu``'s
    are true divisions (a Python number divided by a tensor is a reciprocal
    times that number in PyTorch)."""
    safe_top = max(ptop, 1e-3)
    num = torch.tensor(rf_cutoff, dtype=p.dtype, device=p.device)
    span = torch.tensor(math.log(rf_cutoff / safe_top), dtype=p.dtype, device=p.device)
    x = torch.log(num / torch.clamp(p, min=safe_top)) / span
    r = (1.0 / tau) * torch.sin(0.5 * math.pi * torch.clamp(x, 0.0, 1.0)) ** 2
    return torch.where(p < rf_cutoff, r, torch.zeros_like(r))


def ray_fast(u, v, w, pe_mid, dt: float, ptop: float, rf_cutoff: float, tau: float):
    """Rayleigh friction of ``u, v`` (and ``w`` when given) above
    ``rf_cutoff`` with timescale ``tau`` [s]: each is multiplied by ``1 / (1
    + dt r(p))`` of the layer-mean pressure ``pe_mid`` at cell centers,
    averaged over the two cells of each wind point. ``tau <= 0`` returns the
    winds themselves."""
    if tau <= 0.0:
        return u, v, w
    damp_c = torch.reciprocal(1.0 + dt * rayleigh_rate(pe_mid, ptop, rf_cutoff, tau))
    damp_u = 0.5 * (y_cell_to_left_iface(damp_c) + y_cell_to_right_iface(damp_c))
    damp_v = 0.5 * (x_cell_to_left_iface(damp_c) + x_cell_to_right_iface(damp_c))
    u = u * damp_u
    v = v * damp_v
    if w is not None:
        w = w * damp_c
    return u, v, w


def fillz(q, delp):
    """Vertical filling of negative tracers by column borrowing: a downward
    sweep absorbs each layer's deficit into the layer below, then the
    leftover bottom deficit propagates back up. Conservative in column
    tracer mass except for the final clip of a column that is negative in
    total. ``q (.., K, Y, X)`` with ``delp`` broadcastable to it (``delp[:,
    None]`` for a stacked ``(S, nq, K, Y, X)`` block)."""
    mass = q * delp
    K = q.shape[-3]

    def sweep(layers, carry):
        out = []
        for m_k in layers:
            m = m_k + carry
            carry = torch.clamp(m, max=0.0)
            out.append(torch.clamp(m, min=0.0))
        return carry, out

    deficit, m_down = sweep([mass[..., k, :, :] for k in range(K)],
                            torch.zeros_like(mass[..., 0, :, :]))
    _, m_up = sweep(m_down[::-1], deficit)
    m_new = torch.stack(m_up[::-1], dim=-3)
    return m_new / torch.broadcast_to(delp, q.shape)


def neg_adj3(q, delp, pt=None, pkz=None, nwat: int = 6):
    """Adjust negative water species: balance deficits inside the water
    families, then condense or deposit the rest from vapor with the matching
    latent heating, then fill each column (:func:`fillz`) and clip.

    Order (tracer layout per ``TRACER_NAMES``): 1. negative qi/qs/qg filled
    from the other frozen species; 2. remaining frozen deficits deposited
    from qv (ls heating); 3. ql and qr fill each other; 4. remaining liquid
    deficits condensed from qv (lv heating); 5. negative qv evaporates ql,
    then sublimates qi (cooling); 6. fillz of every tracer.

    ``pt`` (virtual potential temperature) and ``pkz`` enable the latent
    heating; without them the adjustment moves mass only. ``q (S, nq, K, Y,
    X)``, ``delp (S, K, Y, X)``. Returns ``(q, pt)``; ``nwat`` is accepted as
    in ``pace_tpu`` and does not change the scheme."""
    iv, il, ii, ir, is_, ig = (TRACER_NAMES.index(n) for n in
                               ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel"))
    qv, ql, qi, qr, qs, qg = (q[:, j] for j in (iv, il, ii, ir, is_, ig))
    t_abs = None
    if pt is not None and pkz is not None:
        t_abs = pt * pkz / (1.0 + constants.ZVIR * qv)
    lv = constants.HLV
    ls = constants.HLV + constants.HLF
    cp = constants.CP_AIR

    def fill_from(neg, donor):
        """Move min(deficit, donor) from donor into the negative species."""
        deficit = torch.clamp(-neg, min=0.0)
        take = torch.minimum(deficit, torch.clamp(donor, min=0.0))
        return neg + take, donor - take, take

    # 1. frozen family internal balancing
    qi, qs, _ = fill_from(qi, qs)
    qi, qg, _ = fill_from(qi, qg)
    qs, qg, _ = fill_from(qs, qg)
    qg, qs, _ = fill_from(qg, qs)
    # 2. remaining frozen deficits deposit from vapor (ls heating)
    qi, qv, took = fill_from(qi, qv)
    if t_abs is not None:
        t_abs = t_abs + (ls / cp) * took
    qs, qv, took = fill_from(qs, qv)
    if t_abs is not None:
        t_abs = t_abs + (ls / cp) * took
    qg, qv, took = fill_from(qg, qv)
    if t_abs is not None:
        t_abs = t_abs + (ls / cp) * took
    # 3. liquid family internal balancing
    ql, qr, _ = fill_from(ql, qr)
    qr, ql, _ = fill_from(qr, ql)
    # 4. remaining liquid deficits condense from vapor (lv heating)
    ql, qv, took_l = fill_from(ql, qv)
    qr, qv, took_r = fill_from(qr, qv)
    if t_abs is not None:
        t_abs = t_abs + (lv / cp) * (took_l + took_r)
    # 5. negative vapor evaporates liquid then sublimates ice (cooling)
    qv, ql, took_e = fill_from(qv, ql)
    qv, qi, took_s = fill_from(qv, qi)
    if t_abs is not None:
        t_abs = t_abs - (lv / cp) * took_e - (ls / cp) * took_s

    q = q.clone()
    for j, val in zip((iv, il, ii, ir, is_, ig), (qv, ql, qi, qr, qs, qg)):
        q[:, j] = val
    # 6. column fill + clip for every tracer (incl. non-water)
    q = fillz(q, delp[:, None])
    if t_abs is not None:
        pt = t_abs * (1.0 + constants.ZVIR * q[:, iv]) / pkz
    return q, pt


def sat_adjust(pt, qv, ql, qi=None, qr=None, qs=None, qg=None, p_mid=None, pkz=None,
               dt: float = 0.0, config=None):
    """Fast saturation adjustment over the six water species (reference
    ``SatAdjust3d``, applied in the Remapping stage with ``do_sat_adj``):
    the microphysics' :func:`fast_saturation_adjustment` on the temperature
    ``pt * pkz / (1 + zvir qv)`` of the virtual potential temperature
    ``pt``, which is rebuilt with the updated vapor.

    Returns (pt, qv, ql, qi, qr, qs, qg, qa); qa is None unless
    ``config.do_qa``. The ice species may be None (vapor/liquid-only
    configurations) and then come back as None.
    """
    if config is None:
        config = MicrophysicsConfig()
    z = torch.zeros_like(qv)
    has_ice = qi is not None
    t = pt * pkz / (1.0 + constants.ZVIR * qv)
    qv2, ql2, qi2, qr2, qs2, qg2, t2, qa = fast_saturation_adjustment(
        qv, ql,
        qi if qi is not None else z,
        qr if qr is not None else z,
        qs if qs is not None else z,
        qg if qg is not None else z,
        t, p_mid, dt, config,
    )
    pt2 = t2 * (1.0 + constants.ZVIR * qv2) / pkz
    if not has_ice:
        return pt2, qv2, ql2, None, None, None, None, qa
    return pt2, qv2, ql2, qi2, qr2, qs2, qg2, qa


def cloud_fraction(qv, ql, t, p_mid, rh_crit: float = 0.75, ql_full: float = 1.5e-4):
    """Diagnostic cloud fraction: fully cloudy once condensate reaches
    ``ql_full``, partially cloudy from relative humidity above ``rh_crit``
    (the square of a linear ramp), whichever is larger."""
    qsat = saturation_mixing_ratio(t, p_mid)
    rh = torch.clamp(qv / torch.clamp(qsat, min=1e-12), 0.0, 1.0)
    qa_rh = torch.clamp((rh - rh_crit) / (1.0 - rh_crit), 0.0, 1.0)
    qa_ql = torch.clamp(ql / ql_full, 0.0, 1.0)
    return torch.maximum(qa_rh * qa_rh, qa_ql)


def global_energy_fix_increment(te1, te2, cvm, delp, area, n_halo: int, consv: float):
    """The globally uniform temperature increment [K] that restores the
    remap's loss of total energy (``consv_te``; a global-integral fixer in
    the Remapping stage, not a per-column closure):

        dT = consv * sum((te1 - te2) area) / sum(sum_k(cvm delp) area)

    Both sums run over every shard's compute domain (each cell of the cube
    once); on one device that is a sum over the stacked shards, on a mesh
    each rank's sums added over the ranks (one all-reduce of both), as the
    program's are. Returns
    a 0-dim tensor on the operands' device (no host sync), to be applied as
    ``pt += dT / pkz``."""
    sl = (..., slice(n_halo, -n_halo), slice(n_halo, -n_halo))
    w_area = area[sl]
    dte = torch.sum((te1 - te2)[sl] * w_area)
    denom = torch.sum(torch.sum(cvm * delp, dim=-3)[sl] * w_area)
    if get_shard_mesh() is not None:
        dte, denom = all_reduce(torch.stack([dte, denom]), "sum")
    return consv * dte / denom


def total_energy_columns(u, v, w, delp, pt, pkz, phis):
    """Column-integrated total energy [J/m^2 / g]: internal, kinetic (winds
    averaged to cell centers; ``w`` left out where it is None) and potential
    (the surface geopotential times the column mass). The ``consv_te``
    fixer's te1 and te2."""
    t = pt * pkz  # virtual temperature (the moisture factor cancels in te1 - te2)
    u_c = 0.5 * (u[..., :-1, :] + u[..., 1:, :])
    v_c = 0.5 * (v[..., :, :-1] + v[..., :, 1:])
    ke = 0.5 * (u_c**2 + v_c**2)
    if w is not None:
        ke = ke + 0.5 * w**2
    e = delp * (constants.CV_AIR * t + ke)
    return torch.sum(e, dim=-3) + phis * torch.sum(delp, dim=-3)
