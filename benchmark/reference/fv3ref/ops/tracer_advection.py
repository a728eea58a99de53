"""Sub-cycled multi-tracer 2-D transport (flux-form, mass-consistent).

Port of ``pace_tpu.ops.tracer_advection`` (reference role:
``pyFV3.stencils.tracer_2d_1l.TracerAdvection``). All tracers are carried in
ONE stacked tensor ``(S, nq, K, Y, X)``; each sub-cycle exchanges the whole
block once (x-fold plus the y-fold's corner pack), computes its fluxes
tracer by tracer, syncs the
tile-edge fluxes and updates the block.

The sub-cycle count is either static (``n_split``) or derived from the
global max courant number (``dynamic=True``, the reference tracer_2d_1l
behavior): n = floor(max|c|) + 1, bounded by ``MAX_DYNAMIC_SUBCYCLES``. The
port runs eagerly, so the count is read back to the host once per call
and the sub-cycles are a Python loop.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import all_reduce
from .folds import CornerPatch
from .fvtp2d import fvtp2d_tracer
from .stencil_utils import bcast_k, x_iface_diff, y_iface_diff

#: bound on the runtime-derived sub-cycle count (dynamic=True); a count
#: above it would mean a per-substep courant > 3, far outside the transport
#: scheme's stability envelope
MAX_DYNAMIC_SUBCYCLES = 4


def subcycle_count(crx, cry, n_halo: int, n_split: int = 1) -> int:
    """floor(max|c|) + 1 over the compute domain, at least ``n_split``,
    clipped to [1, MAX_DYNAMIC_SUBCYCLES]. The max is taken over interior
    faces only: the corner ghost zones of the halo-padded courant tensors
    are never read by a stencil and may hold junk. On a mesh it is the max
    over every rank's shards (an all-reduce), so that all ranks take the
    same count, as the program's does. A NaN or infinite maximum gives
    ``n_split`` (clipped), as ``pace_tpu``'s saturating conversion to an
    integer does.

    One ``.item()``: a host sync that waits for every queued kernel."""
    sl = slice(n_halo, -n_halo) if n_halo else slice(None)
    c_max = all_reduce(torch.maximum(
        crx[..., sl, sl].abs().max(), cry[..., sl, sl].abs().max()
    ), "max").item()
    floor = math.floor(c_max) if math.isfinite(c_max) else 0
    return int(min(max(floor + 1, n_split, 1), MAX_DYNAMIC_SUBCYCLES))


def advect_tracers(
    q,
    dp1,
    crx,
    cry,
    xfx,
    yfx,
    mfx,
    mfy,
    halo,
    grid,
    hord: int = 8,
    n_split: int = 1,
    dynamic: bool = False,
):
    """Advance tracers through the accumulated dynamics mass fluxes.

    ``q``: tracers ``(S, nq, K, Y, X)`` (mixing ratios w.r.t. dp1); ``dp1``:
    pressure thickness ``(S, K, Y, X)`` before the mass-flux update;
    ``crx/cry``: time-integrated courant numbers; ``xfx/yfx``: area fluxes
    [m^2]; ``mfx/mfy``: mass fluxes [Pa m^2]; ``halo``: HaloExchanger;
    ``grid``: GridData; ``hord``: PPM variant (monotone 8 default);
    ``n_split``: static sub-cycle count, or the minimum when ``dynamic``.

    Returns ``(q_new, dp2)``.
    """
    n = subcycle_count(crx, cry, grid.n_halo, n_split) if dynamic else n_split
    frac = 1.0 / float(n)
    crx = crx * frac
    cry = cry * frac
    xfx = xfx * frac
    yfx = yfx * frac
    mfx = mfx * frac
    mfy = mfy * frac
    rarea = grid.rarea

    for _ in range(n):
        dp2 = dp1 + (x_iface_diff(mfx) + y_iface_diff(mfy)) * bcast_k(rarea, dp1)
        # one fold + corner pack: the y-fold tracer block is rebuilt inside
        # the kernel from the pack, never materialized in device memory
        qx_all, qp = halo.update_scalar_fold_patch(q, stagger="center")
        fx, fy = fvtp2d_tracer(
            qx_all, CornerPatch(qp), crx, cry, xfx, yfx, grid.area, mfx, mfy, hord
        )
        # single-valued cross-tile-edge fluxes (exact conservation)
        fx, fy = halo.sync_vector_interfaces(fx, fy, kind="cgrid")
        q = (
            q * dp1[:, None]
            + (x_iface_diff(fx) + y_iface_diff(fy)) * bcast_k(rarea, q)
        ) / dp2[:, None]
        dp1 = dp2
    return q, dp1
