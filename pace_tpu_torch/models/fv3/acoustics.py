"""Acoustic substep, C-grid half.

Port of the first half of ``pace_tpu.models.fv3.acoustics._one_substep``
(reference role: ``pyFV3.stencils.dyn_core.AcousticDynamics``): the halo
exchanges of the substep, the C-grid shallow-water half step ``c_sw``, the
hydrostatic interface chain and the C-grid pressure gradient. The D-grid
half (``d_sw``, the D-grid pressure gradient) and the ``n_split`` loop are
not ported yet.

Corner-fold protocol (see pace_tpu_torch.parallel.topology): every sweep
direction gets ghost data folded for that direction — u is y-swept (use
fold="y"), v is x-swept (fold="x"), each transported scalar gets both folds
(the y fold as a corner pack, see ops.folds.CornerPatch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...ops.c_sw import CGridState, c_sw
from ...ops.folds import CornerPatch
from ...ops.hydro_kernel import hydrostatic_interfaces_best
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


def c_grid_half(u, v, w, delp, pt, delz, phis, grid, halo, config: AcousticConfig,
                dt2: float, ptop: float) -> CGridHalf:
    """The C-grid half of one acoustic substep, from the substep's halo
    exchanges to the exchanged C-grid winds the D-grid solver advects with.

    Inputs are stacked tensors (S, K, Y, X) (``u``/``v`` D-grid staggered,
    ``phis`` (S, Y, X)) on one device; ``pt`` is virtual potential
    temperature, ``dt2`` half the acoustic time step. ``w`` and ``delz`` are
    carried by the nonhydrostatic configuration only. ``_one_substep`` will
    call this function once the D-grid half exists.
    """
    if not config.hydrostatic:
        raise NotImplementedError(
            "the nonhydrostatic C-grid half needs heights_from_delz, updatedz_c "
            "and riem_solver_c (TPU kernel rows 8, 9 and 11 of PERF.md), which "
            "are not ported yet; use AcousticConfig(hydrostatic=True)"
        )
    # the scalar exchange is started first and awaited after the vector
    # exchange, which does not depend on it
    fields = [delp, pt]
    if w is not None:
        fields.append(w)
    scalar_hdl = halo.start_update_scalars_fold_patches(fields)
    # only the consumed folds: u is y-swept, v x-swept
    u_y, v_x = halo.update_vector_fold_pair(u, v, kind="dgrid")
    pairs = scalar_hdl.wait()
    (delp_x, delp_p), (pt_x, pt_p) = pairs[:2]
    w_x, w_y = (pairs[2][0], CornerPatch(pairs[2][1])) if w is not None else (None, None)

    # --- C-grid half step + its pressure gradient
    cg = c_sw(u_y, v_x, delp_x, pt_x, grid, halo, dt2)
    _pe, _peln, pkc, pkz_c, gz_c = hydrostatic_interfaces_best(
        cg.delpc, cg.ptc, phis, ptop, need=("pk", "pkz", "gz")
    )
    uc, vc = p_grad_c(cg.uc, cg.vc, pkc, gz_c, grid, dt2)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    (uc_x, vc_x), (uc_y, vc_y) = halo.update_vector_folds(uc, vc, kind="cgrid")
    return CGridHalf(
        cg=cg, uc_x=uc_x, vc_x=vc_x, uc_y=uc_y, vc_y=vc_y, u_y=u_y, v_x=v_x,
        delp_x=delp_x, delp_y=CornerPatch(delp_p), pt_x=pt_x, pt_y=CornerPatch(pt_p),
        pkz_c=pkz_c, w_x=w_x, w_y=w_y,
    )
