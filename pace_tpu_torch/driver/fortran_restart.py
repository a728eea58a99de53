"""Fortran FV3GFS restart ingestion.

Port of ``pace_tpu.driver.fortran_restart`` (reference role:
``pyFV3.DycoreState.from_fortran_restart`` + ``FortranRestartInit``: detect
by fv_core.res.nc, read per-tile fv_core.res.tile*.nc / fv_tracer.res.tile*.nc
/ fv_srf_wnd.res.tile*.nc, parse coupler.res for the start time, recompute
pe/peln from delp).

Reads happen host-side through the port's NetCDF-3 reader; each shard takes
its own subtile slice of the tile arrays. The prognostics' halos are then
refreshed through the port's halo exchange on the state's device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import constants
from ..constants import TRACER_NAMES
from ..models.fv3.state import DycoreState
from ..utils import netcdf3

#: Fortran tracer name -> framework tracer name
FORTRAN_TRACER_NAMES = {
    "sphum": "qvapor",
    "liq_wat": "qliquid",
    "ice_wat": "qice",
    "rainwat": "qrain",
    "snowwat": "qsnow",
    "graupel": "qgraupel",
    "o3mr": "qo3mr",
    "sgs_tke": "qsgs_tke",
    "cld_amt": "qcld",
}


@dataclasses.dataclass(frozen=True)
class CouplerRes:
    """Parsed coupler.res (calendar + model start/current time)."""

    calendar: int
    start_time: Tuple[int, int, int, int, int, int]
    current_time: Tuple[int, int, int, int, int, int]


def is_fortran_restart(path: str) -> bool:
    """Whether ``path`` holds a Fortran-format restart, which the reference
    detects by the presence of ``fv_core.res.nc``."""
    return os.path.exists(os.path.join(path, "fv_core.res.nc"))


def read_coupler_res(path: str) -> CouplerRes:
    lines = open(path).read().splitlines()
    nums = []
    for ln in lines:
        found = re.findall(r"-?\d+", ln.split("(")[0] if "(" in ln else ln)
        nums.append([int(x) for x in found])
    calendar = nums[0][0]
    start = tuple(nums[1][:6])
    current = tuple(nums[2][:6])
    return CouplerRes(calendar, start, current)


def coupler_elapsed_seconds(path: str) -> float:
    """Seconds from the start time to the current time of ``coupler.res``
    in ``path``: where a run restarted from this directory resumes its
    clock."""
    c = read_coupler_res(os.path.join(path, "coupler.res"))
    return (datetime.datetime(*c.current_time)
            - datetime.datetime(*c.start_time)).total_seconds()


def _read_tiles(path: str, stem: str, n_tiles: int) -> Dict[str, np.ndarray]:
    """Read per-tile files and stack on a leading tile axis; drops the
    length-1 Time record axis."""
    out: Dict[str, list] = {}
    for t in range(n_tiles):
        f = netcdf3.read(os.path.join(path, f"{stem}.tile{t + 1}.nc"))
        for nm, v in f.variables.items():
            if nm in f.dims:
                continue
            arr = np.asarray(v.data, dtype=np.float64)
            if v.dims and v.dims[0] == "Time":
                arr = arr[0]
            out.setdefault(nm, []).append(arr)
    return {nm: np.stack(tiles) for nm, tiles in out.items()}


def _to_shards(tile_arr: np.ndarray, mt, y_stag: int = 0, x_stag: int = 0):
    """Scatter a per-tile array (T, [K,] ny(+y_stag), nx(+x_stag)) into the
    halo-padded stacked-shard layout (S, [K,] Y+..., X+...); interior only,
    halos left zero (refreshed by the halo exchange on first use)."""
    halo = mt.halo
    h = halo.n_halo
    S = halo.n_shards
    nsy, nsx = halo.nsy, halo.nsx
    lead = tile_arr.shape[1:-2]
    Ys = nsy + 2 * h + (1 if y_stag else 0)
    Xs = nsx + 2 * h + (1 if x_stag else 0)
    out = np.zeros((S,) + lead + (Ys, Xs), dtype=tile_arr.dtype)
    for s in range(S):
        t, py, px = halo._shard_info(s)
        y0 = py * nsy
        x0 = px * nsx
        sub = tile_arr[
            t,
            ...,
            y0 : y0 + nsy + y_stag,
            x0 : x0 + nsx + x_stag,
        ]
        out[s, ..., h : h + nsy + y_stag, h : h + nsx + x_stag] = sub
    return out


def load_fortran_restart(path: str, mt, device="cuda", dtype=torch.float32) -> DycoreState:
    """Build a DycoreState on ``device`` from a directory of FV3GFS Fortran
    restart files."""
    n_tiles = constants.N_TILES
    core = _read_tiles(path, "fv_core.res", n_tiles)
    tracers = _read_tiles(path, "fv_tracer.res", n_tiles)

    u = _to_shards(core["u"], mt, y_stag=1)  # (S, K, Y+1, X)
    v = _to_shards(core["v"], mt, x_stag=1)
    w = _to_shards(core["W"], mt)
    delz = _to_shards(core["DZ"], mt)
    temp = _to_shards(core["T"], mt)
    delp = _to_shards(core["delp"], mt)
    phis = _to_shards(core["phis"], mt)

    S, K = delp.shape[:2]
    Y, X = delp.shape[2:]
    q = np.zeros((S, len(TRACER_NAMES), K, Y, X))
    for fname, arr in tracers.items():
        ours = FORTRAN_TRACER_NAMES.get(fname)
        if ours is None:
            continue
        q[:, TRACER_NAMES.index(ours)] = _to_shards(arr, mt)

    # derived pressure variables from delp (the reference recomputes pe and
    # peln on a restart)
    ptop = float(mt.ak[0])
    pe = np.concatenate(
        [
            np.full((S, 1, Y, X), ptop),
            ptop + np.cumsum(delp, axis=1),
        ],
        axis=1,
    )
    ps = pe[:, -1]
    peln = np.log(np.maximum(pe, 1e-10))
    pk = (pe / constants.P_REF) ** constants.KAPPA
    pkz_h = (pk[:, 1:] - pk[:, :-1]) / (
        constants.KAPPA * (peln[:, 1:] - peln[:, :-1])
    )
    # nonhydrostatic layer-mean Exner from the gas law where delz is valid
    qv = q[:, TRACER_NAMES.index("qvapor")]
    t_v = temp * (1.0 + constants.ZVIR * qv)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_gas = (
            constants.RDGAS
            * (delp / constants.GRAV)
            * t_v
            / (constants.P_REF**constants.KAPPA * np.maximum(-delz, 1e-30))
        )
        p_full = x_gas ** (1.0 / (1.0 - constants.KAPPA))
        pkz_nh = (p_full / constants.P_REF) ** constants.KAPPA
    interior = np.zeros((S, 1, Y, X), dtype=bool)
    h = mt.halo.n_halo
    interior[:, :, h : Y - h, h : X - h] = True
    pkz = np.where(np.isfinite(pkz_nh) & interior, pkz_nh, pkz_h)

    # the dycore's prognostic heat variable is virtual potential temperature
    pt = t_v / pkz

    zc = np.zeros_like(delp)
    state = DycoreState.from_numpy(
        dict(
            u=u, v=v, delp=delp, pt=pt, q=q, w=w, delz=delz, phis=phis, ps=ps, pe=pe,
            peln=peln, pk=pk, pkz=pkz, ua=zc, va=zc, uc=np.zeros_like(v),
            vc=np.zeros_like(u), mfxd=np.zeros_like(v), mfyd=np.zeros_like(u),
            cxd=np.zeros_like(v), cyd=np.zeros_like(u), diss_estd=zc,
        ),
        device=device, dtype=dtype,
    )
    # refresh halos of the prognostics so the first step reads true ghosts
    halo = mt.halo
    state = dataclasses.replace(
        state,
        delp=halo.update_scalar(state.delp, fold="x"),
        pt=halo.update_scalar(state.pt, fold="x"),
        w=halo.update_scalar(state.w, fold="x"),
        delz=halo.update_scalar(state.delz, fold="x"),
        phis=halo.update_scalar(state.phis, fold="x"),
    )
    u2, v2 = halo.sync_vector_interfaces(state.u, state.v, kind="dgrid")
    u2, v2 = halo.update_vector(u2, v2, kind="dgrid", fold="x")
    return dataclasses.replace(state, u=u2, v=v2)


def load_surface_winds(path: str, mt) -> Optional[Dict[str, np.ndarray]]:
    """u_srf/v_srf from fv_srf_wnd.res.tile*.nc (if present)."""
    if not os.path.exists(os.path.join(path, "fv_srf_wnd.res.tile1.nc")):
        return None
    srf = _read_tiles(path, "fv_srf_wnd.res", constants.N_TILES)
    return {nm: _to_shards(arr, mt) for nm, arr in srf.items()}
