"""Acoustic substep, C-grid half.

Port of the first half of ``pace_tpu.models.fv3.acoustics._one_substep``
(reference role: ``pyFV3.stencils.dyn_core.AcousticDynamics``): the halo
exchanges of the substep, the C-grid shallow-water half step ``c_sw``, the
hydrostatic interface chain or, in the nonhydrostatic configuration, the
interface-height update and the provisional vertical solve, and the C-grid
pressure gradient. The D-grid half (``d_sw``, the D-grid pressure gradient)
and the ``n_split`` loop are not ported yet.

Corner-fold protocol (see pace_tpu_torch.parallel.topology): every sweep
direction gets ghost data folded for that direction — u is y-swept (use
fold="y"), v is x-swept (fold="x"), each transported scalar gets both folds
(the y fold as a corner pack, see ops.folds.CornerPatch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ... import constants
from ...ops.c_sw import CGridState, c_sw
from ...ops.folds import CornerPatch
from ...ops.hydro_kernel import hydrostatic_interfaces_best
from ...ops.nonhydro import heights_from_delz, riem_solver_c, updatedz_c
from ...ops.pgrad import p_grad_c


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """Acoustic-loop parameters (the fields and defaults of ``pace_tpu``'s
    ``AcousticConfig``, less ``d_sw``, which arrives with the D-grid
    solver)."""

    n_split: int = 1
    hydrostatic: bool = True
    # nonhydrostatic params
    a_imp: float = 1.0
    p_fac: float = 0.05
    beta: float = 0.0
    #: cap on the per-substep dissipation-heating temperature increment,
    #: |dT| <= delt_max * dt [K]
    delt_max: float = 0.002
    #: rf_fast: apply Rayleigh damping per acoustic substep; off -> once per
    #: k_split step in the tail
    rf_fast: bool = False
    rf_cutoff: float = 750.0
    tau: float = 0.0


@dataclasses.dataclass(frozen=True)
class CGridHalf:
    """What the C-grid half of a substep hands to the D-grid half."""

    cg: CGridState
    #: C-grid winds after the pressure gradient, interface-synced, in both folds
    uc_x: torch.Tensor
    vc_x: torch.Tensor
    uc_y: torch.Tensor
    vc_y: torch.Tensor
    #: the D-grid winds in the fold each is swept in
    u_y: torch.Tensor
    v_x: torch.Tensor
    #: transported scalars: x fold, and the y fold as a corner pack
    delp_x: torch.Tensor
    delp_y: CornerPatch
    pt_x: torch.Tensor
    pt_y: CornerPatch
    #: layer-mean pk of the provisional C-grid state
    pkz_c: torch.Tensor
    w_x: Optional[torch.Tensor] = None
    w_y: Optional[CornerPatch] = None
    #: nonhydrostatic only, for the D-grid half: the exchanged ``delz``
    #: (x fold), the interface heights built from it before the advection,
    #: in both folds, and both folds of ``phis``
    delz_x: Optional[torch.Tensor] = None
    zh_x: Optional[torch.Tensor] = None
    zh_y: Optional[torch.Tensor] = None
    phis_folds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #: nonhydrostatic only: the advected interface heights, the surface
    #: velocity they imply, the solved provisional thicknesses and the full
    #: interface pressure [Pa] that ``p_grad_c`` used
    zh_c: Optional[torch.Tensor] = None
    ws_c: Optional[torch.Tensor] = None
    delz_c: Optional[torch.Tensor] = None
    pe_c: Optional[torch.Tensor] = None


def c_grid_half(u, v, w, delp, pt, delz, phis, grid, halo, config: AcousticConfig,
                dt2: float, ptop: float, phis_folds=None) -> CGridHalf:
    """The C-grid half of one acoustic substep, from the substep's halo
    exchanges to the exchanged C-grid winds the D-grid solver advects with.

    Inputs are stacked tensors (S, K, Y, X) (``u``/``v`` D-grid staggered,
    ``phis`` (S, Y, X)) on one device; ``pt`` is virtual potential
    temperature, ``dt2`` half the acoustic time step. ``w`` and ``delz`` are
    carried by the nonhydrostatic configuration only, which needs both.
    ``phis_folds`` is ``halo.update_scalar_folds(phis)``, constant over the
    substeps; it is computed here when absent. ``_one_substep`` will call
    this function once the D-grid half exists.
    """
    hydro = config.hydrostatic
    if not hydro and (w is None or delz is None):
        raise ValueError("nonhydrostatic mode requires w and delz")
    # the scalar exchange is started first and awaited after the vector
    # exchange, which does not depend on it
    fields = [delp, pt]
    if w is not None:
        fields.append(w)
    scalar_hdl = halo.start_update_scalars_fold_patches(fields)
    # only the consumed folds: u is y-swept, v x-swept
    u_y, v_x = halo.update_vector_fold_pair(u, v, kind="dgrid")
    # delz needs real full folds: its y fold feeds the height column sum
    delz_y = None
    if not hydro:
        delz, delz_y = halo.update_scalar_folds(delz)
    pairs = scalar_hdl.wait()
    (delp_x, delp_p), (pt_x, pt_p) = pairs[:2]
    w_x, w_y = (pairs[2][0], CornerPatch(pairs[2][1])) if w is not None else (None, None)

    # --- C-grid half step + its pressure gradient
    cg = c_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
    nh = {}
    if hydro:
        _pe, _peln, pkc, pkz_c, gz_c = hydrostatic_interfaces_best(
            cg.delpc, cg.ptc, phis, ptop, need=("pk", "pkz", "gz")
        )
        uc, vc = p_grad_c(cg.uc, cg.vc, pkc, gz_c, grid, dt2)
    else:
        _pe, _peln, _pk, pkz_c, _gz = hydrostatic_interfaces_best(
            cg.delpc, cg.ptc, phis, ptop, need=("pkz",)
        )
        # advect the interface heights with the C-grid winds that advected
        # delpc/ptc, so the provisional solve sees consistent heights and
        # the terrain-following ws they imply; each fold of delz is paired
        # with the same fold of phis
        if phis_folds is None:
            phis_folds = halo.update_scalar_folds(phis)
        phis_cx, phis_cy = phis_folds
        zh_cx = heights_from_delz(delz, phis_cx)
        zh_cy = heights_from_delz(delz_y, phis_cy)
        zh_c, ws_c = updatedz_c(zh_cx, zh_cy, cg.xfx, cg.yfx, grid, dt2)
        delz_c = zh_c[..., 1:, :, :] - zh_c[..., :-1, :, :]
        pe_full_c, delz_c_new = riem_solver_c(
            w_x, delz_c, cg.ptc, cg.delpc, pkz_c, ws_c, dt2, ptop,
            a_imp=config.a_imp, p_fac=config.p_fac,
        )
        # p_grad_c heights from the SOLVED provisional thicknesses, and the
        # contour PGF with the full pressure in Pa
        gz_c = heights_from_delz(delz_c_new, phis) * constants.GRAV
        uc, vc = p_grad_c(cg.uc, cg.vc, pe_full_c, gz_c, grid, dt2)
        nh = dict(delz_x=delz, zh_x=zh_cx, zh_y=zh_cy, phis_folds=phis_folds, zh_c=zh_c,
                  ws_c=ws_c, delz_c=delz_c_new, pe_c=pe_full_c)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    return CGridHalf(
        cg=cg, uc_x=uc_x, vc_x=vc_x, uc_y=uc_y, vc_y=vc_y, u_y=u_y, v_x=v_x,
        delp_x=delp_x, delp_y=CornerPatch(delp_p), pt_x=pt_x, pt_y=CornerPatch(pt_p),
        pkz_c=pkz_c, w_x=w_x, w_y=w_y, **nh,
    )
