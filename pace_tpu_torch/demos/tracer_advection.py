"""Cubed-sphere tracer transport at the dycore's settings.

Counterpart of ``examples/tracer_advection_demo.py``: cosine bells carried by
a solid-body rotation (Williamson et al. 1992, test case 1) through the
model's own operators, configured as the dycore's TracerAdvection stage
(``pace_tpu/models/fv3/dycore.py:273-288``) runs them:

1. mass fluxes as d_sw builds them: ``fvtp2d_best`` of ``delp`` with
   ``hord_dp=6`` (y-fold as a corner pack), then ``sync_vector_interfaces``;
2. ``advect_tracers`` with ``hord_tr=8`` and dynamic sub-cycling over the
   stacked tracer block (all nine tracers of the dycore state by default).

Face fluxes come from a corner streamfunction, so they are discretely
nondivergent: dp stays constant to round-off and tracer mass is conserved to
round-off. ``delp`` is the hybrid coordinate's layer thickness at
``ps = 1e5`` Pa; each tracer starts as a cosine bell at its own centre.

Run::

    python -m pace_tpu_torch.demos.tracer_advection --n 48 --npz 8 --steps 10
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants
from ..dtypes import check_dtype, resolve_device, to_tensor
from ..grid.generation import GridSpec, MetricTerms
from ..grid.grid_data import GridData
from ..ops.folds import CornerPatch
from ..ops.fvtp2d import fvtp2d_best
from ..ops.tracer_advection import advect_tracers, subcycle_count
from ..parallel.halo import HaloExchanger

#: surface pressure of the layer thicknesses [Pa]
PS = 1.0e5


def lon_lat(xyz):
    lon = np.arctan2(xyz[..., 1], xyz[..., 0])
    lat = np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0))
    return lon, lat


def cosine_bell(lon, lat, lon_c, lat_c, radius_frac=1.0 / 3.0):
    """Williamson case-1 initial condition (100 + smooth bump up to 1000)."""
    r = constants.RADIUS * np.arccos(
        np.clip(
            np.sin(lat_c) * np.sin(lat)
            + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c),
            -1.0,
            1.0,
        )
    )
    rr = radius_frac * constants.RADIUS
    return np.where(r < rr, 100.0 + 450.0 * (1.0 + np.cos(math.pi * r / rr)), 100.0)


def bell_centres(nq: int):
    """(lon, lat) of tracer t's bell: spread in longitude, alternating
    latitude bands."""
    return [
        (1.5 * math.pi + 2.0 * math.pi * t / nq, (t % 3 - 1) * math.pi / 6.0)
        for t in range(nq)
    ]


@dataclasses.dataclass
class TracerCase:
    """Grid, halo and the transport inputs of one run: time-integrated
    courant numbers and area fluxes ``(S, K, ·, ·)``, tracers ``(S, nq, K,
    Y, X)`` and layer thicknesses ``(S, K, Y, X)``."""

    grid: GridData
    halo: HaloExchanger
    q: torch.Tensor
    delp: torch.Tensor
    crx: torch.Tensor
    cry: torch.Tensor
    xfx: torch.Tensor
    yfx: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays: dict, grid: GridData, halo: HaloExchanger, device="cuda", dtype=torch.float32):
        """The case from numpy arrays keyed ``q, delp, crx, cry, xfx,
        yfx`` (identical inputs for a run and its reference)."""
        dev = resolve_device(device)
        check_dtype(dtype)
        t = {
            k: to_tensor(arrays[k], dev, dtype)
            for k in ("q", "delp", "crx", "cry", "xfx", "yfx")
        }
        return cls(grid=grid, halo=halo, **t)

    def to_numpy(self) -> dict:
        return {
            k: getattr(self, k).detach().cpu().numpy()
            for k in ("q", "delp", "crx", "cry", "xfx", "yfx")
        }


def build_case(
    n: int = 48,
    npz: int = 8,
    nq: int = len(constants.TRACER_NAMES),
    dt: float = 1800.0,
    alpha: float = 45.0,
    device="cuda",
    dtype=torch.float32,
) -> TracerCase:
    """Generate the C``n`` grid and the case's inputs on ``device``."""
    dev = resolve_device(device)
    check_dtype(dtype)
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device=dev, dtype=dtype)
    halo = mt.halo
    a = math.radians(alpha)
    u0 = 2.0 * math.pi * constants.RADIUS / (12.0 * 86400.0)  # one lap in 12 days

    # discretely nondivergent face fluxes from a corner streamfunction: the
    # flux through a face is the difference of psi at its two end corners
    lon_c, lat_c = lon_lat(mt.xyz_corner)
    psi = (
        -constants.RADIUS
        * u0
        * (np.sin(lat_c) * np.cos(a) - np.cos(lat_c) * np.cos(lon_c) * np.sin(a))
    )

    def t(x):
        return to_tensor(x, dev, dtype)

    xfx = t(dt * (psi[:, :-1, :] - psi[:, 1:, :]))  # (S, Y, X+1)
    yfx = t(dt * (psi[:, :, 1:] - psi[:, :, :-1]))  # (S, Y+1, X)
    # fold-consistent halos: x-direction terms from the x fold, y from the
    # y fold; face fluxes rotate like C-grid winds across tile edges
    xfx_x, _ = halo.update_vector(xfx, yfx, kind="cgrid", fold="x")
    _, yfx_y = halo.update_vector(xfx, yfx, kind="cgrid", fold="y")
    area_x = halo.update_scalar(grid.area, fold="x")
    area_y = halo.update_scalar(grid.area, fold="y")
    # courant number = swept fraction of the upwind cell's area (inner
    # interfaces; the outermost halo interface is never consumed -> 0)
    fx_in = xfx_x[..., 1:-1]
    crx = F.pad(
        fx_in * torch.where(fx_in > 0, 1.0 / area_x[..., :-1], 1.0 / area_x[..., 1:]),
        (1, 1),
    )
    fy_in = yfx_y[..., 1:-1, :]
    cry = F.pad(
        fy_in * torch.where(fy_in > 0, 1.0 / area_y[..., :-1, :], 1.0 / area_y[..., 1:, :]),
        (0, 0, 1, 1),
    )

    def levels(x):  # (S, ·, ·) -> (S, npz, ·, ·), the same wind at every level
        return x[:, None].expand(x.shape[0], npz, *x.shape[1:]).contiguous()

    bells = np.stack(
        [cosine_bell(mt.lon_agrid, mt.lat_agrid, lo, la) for lo, la in bell_centres(nq)],
        axis=1,
    )  # (S, nq, Y, X)
    q = t(np.repeat(bells[:, :, None], npz, axis=2))
    dk = np.diff(mt.ak) + np.diff(mt.bk) * PS  # (npz,)
    delp = t(np.broadcast_to(dk[None, :, None, None], (grid.area.shape[0], npz) + grid.area.shape[1:]))
    return TracerCase(
        grid=grid, halo=halo, q=q, delp=delp,
        crx=levels(crx), cry=levels(cry), xfx=levels(xfx_x), yfx=levels(yfx_y),
    )


def step(case: TracerCase, q, delp, hord_dp: int = 6, hord_tr: int = 8):
    """One transport step: delp mass fluxes, then the tracer block."""
    halo, grid = case.halo, case.grid
    dpx, dpp = halo.update_scalar_fold_patch(delp)
    fl = fvtp2d_best(
        dpx, CornerPatch(dpp), case.crx, case.cry, case.xfx, case.yfx, grid.area, hord_dp
    )
    mfx, mfy = halo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    return advect_tracers(
        q, delp, case.crx, case.cry, case.xfx, case.yfx, mfx, mfy, halo, grid,
        hord=hord_tr, dynamic=True,
    )


def diagnostics(case: TracerCase, q, delp) -> dict:
    """Conservation and shape measures on the interior, in float64."""
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))
    area = case.grid.area[i].double()
    q0, dp0 = case.q[i].double(), case.delp[i].double()
    q1, dp1 = q[i].double(), delp[i].double()
    m0 = (q0 * dp0[:, None] * area[:, None, None]).sum(dim=(0, 2, 3, 4))
    m1 = (q1 * dp1[:, None] * area[:, None, None]).sum(dim=(0, 2, 3, 4))
    rng = float(q0.max() - q0.min())
    return {
        "mass_drift": float(((m1 - m0).abs() / m0).max()),
        "dp_drift": float(((dp1 - dp0).abs() / dp0).max()),
        "q_min": float(q1.min()),
        "q_max": float(q1.max()),
        "q_floor": float(q0.min()) - 1e-3 * rng,
        "finite": bool(torch.isfinite(q1).all() and torch.isfinite(dp1).all()),
    }


def run(
    n: int = 48,
    npz: int = 8,
    nq: int = len(constants.TRACER_NAMES),
    dt: float = 1800.0,
    steps: int = 10,
    alpha: float = 45.0,
    device="cuda",
    dtype=torch.float32,
) -> dict:
    """Build the case and take ``steps`` transport steps. Returns the final
    fields, the sub-cycle count, the wall ms of each step, ms per step over
    the steps after the first (the first also builds the halo index maps)
    and :func:`diagnostics`."""
    case = build_case(n, npz, nq, dt, alpha, device, dtype)
    n_sub = subcycle_count(case.crx, case.cry, case.grid.n_halo)
    q, delp = case.q, case.delp
    sync = torch.cuda.synchronize if q.is_cuda else (lambda: None)
    step_ms = []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        q, delp = step(case, q, delp)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    steady = step_ms[1:] or step_ms
    return {
        "case": case, "q": q, "delp": delp, "n_subcycles": n_sub,
        "step_ms": step_ms, "ms_per_step": sum(steady) / max(len(steady), 1),
        **diagnostics(case, q, delp),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=8)
    ap.add_argument("--nq", type=int, default=len(constants.TRACER_NAMES))
    ap.add_argument("--dt", type=float, default=1800.0, help="timestep [s]")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=45.0, help="rotation-axis tilt [deg]")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    args = ap.parse_args()
    out = run(
        args.n, args.npz, args.nq, args.dt, args.steps, args.alpha, args.device,
        torch.float64 if args.f64 else torch.float32,
    )
    print(f"C{args.n} npz={args.npz} nq={args.nq}: {args.steps} steps, "
          f"{out['n_subcycles']} sub-cycles/step, {out['ms_per_step']:.1f} ms/step")
    for k in ("mass_drift", "dp_drift", "q_min", "q_max", "finite"):
        print(f"{k:11s} {out[k]}")


if __name__ == "__main__":
    main()
