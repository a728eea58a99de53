"""The C-grid half of one acoustic substep from the baroclinic-wave state.

Builds the cubed-sphere grid and the Jablonowski-Williamson (2006) initial
state, then runs ``models.fv3.acoustics.c_grid_half``: the substep's halo
exchanges, ``c_sw`` (d2a2c, the C-grid tail), the hydrostatic interface
chain, ``p_grad_c`` and the exchange of the resulting C-grid winds. With
``--nonhydrostatic`` (``hydrostatic=False``) the half step carries ``w`` and
``delz`` and runs the nonhydrostatic vertical between the chain and the
pressure gradient: the interface heights, their C-grid advection
(``updatedz_c``) and the provisional vertical solve (``riem_solver_c``). The
time step is the dycore benchmark's acoustic step, ``dt = 200 s / (k_split 7
* n_split 8)``, so ``dt2 = dt / 2``.

Every repeat starts from the same initial state (the D-grid half that would
advance it is not ported yet), so repeats time the same work.

Run::

    python -m pace_tpu_torch.demos.cgrid_half_step --n 24 --npz 8 --device cpu
    python -m pace_tpu_torch.demos.cgrid_half_step --n 24 --npz 8 --device cpu \
        --nonhydrostatic
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Tuple

import torch

from .. import constants
from ..dtypes import check_dtype, resolve_device
from ..grid.generation import GridSpec, MetricTerms
from ..grid.grid_data import GridData
from ..models.fv3.acoustics import AcousticConfig, CGridHalf, c_grid_half
from ..models.fv3.state import DycoreState
from ..ops.d2a2c import d2a2c_vect
from ..parallel.halo import HaloExchanger

#: half the acoustic time step of the dycore benchmark [s]
DT2 = 0.5 * 200.0 / (7 * 8)


@dataclasses.dataclass
class CGridCase:
    """Grid, halo and the dycore state of one run."""

    grid: GridData
    halo: HaloExchanger
    state: DycoreState
    config: AcousticConfig
    dt2: float = DT2
    #: both folds of ``phis``, exchanged once (nonhydrostatic only), as the
    #: acoustic loop exchanges them once for all its substeps
    phis_folds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def build_case(n: int = 48, npz: int = 8, device="cuda", dtype=torch.float32,
               perturbation: bool = True, hydrostatic: bool = True) -> CGridCase:
    """Generate the C``n`` grid and the baroclinic-wave state on ``device``."""
    dev = resolve_device(device)
    check_dtype(dtype)
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device=dev, dtype=dtype)
    state = DycoreState.from_baroclinic_init(
        mt, perturbation=perturbation, device=dev, dtype=dtype
    )
    phis_folds = None if hydrostatic else mt.halo.update_scalar_folds(state.phis)
    return CGridCase(grid=grid, halo=mt.halo, state=state,
                     config=AcousticConfig(hydrostatic=hydrostatic), phis_folds=phis_folds)


def step(case: CGridCase) -> CGridHalf:
    """One C-grid half step from the case's state (``w`` and ``delz`` are
    carried in the nonhydrostatic configuration only)."""
    st = case.state
    w, delz = (None, None) if case.config.hydrostatic else (st.w, st.delz)
    return c_grid_half(
        st.u, st.v, w, st.delp, st.pt, delz, st.phis, case.grid, case.halo,
        case.config, case.dt2, case.grid.ptop, phis_folds=case.phis_folds,
    )


def diagnostics(case: CGridCase, half: CGridHalf) -> dict:
    """Conservation and range measures on the compute domain, in float64.
    The nonhydrostatic half step adds: the largest solved thickness
    ``delz_c_max`` (must stay negative), the least interface spacing of the
    advected heights ``dzh_min`` (must stay positive), the departure of their
    bottom interface from the surface height ``zs_pin_err`` (pinned: 0), the
    largest surface velocity ``ws_max`` [m/s] and the largest perturbation
    pressure relative to the hydrostatic interface pressure ``pp_rel_max``."""
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))
    area = case.grid.area[i].double()[:, None]
    delp, pt = case.state.delp[i].double(), case.state.pt[i].double()
    delpc, ptc = half.cg.delpc[i].double(), half.cg.ptc[i].double()
    pkz = half.pkz_c[i]
    m0, m1 = (delp * area).sum(), (delpc * area).sum()
    pt_rng = float(pt.max() - pt.min())
    outputs = [half.cg.delpc, half.cg.ptc, half.cg.divg_d, half.uc_x, half.vc_x,
               half.uc_y, half.vc_y, half.pkz_c]
    nh = {}
    if not case.config.hydrostatic:
        outputs += [half.zh_c, half.ws_c, half.delz_c, half.pe_c]
        zh = half.zh_c[i].double()
        pe_hyd = case.grid.ptop + torch.cumsum(delpc, dim=1)
        pp = half.pe_c[i].double()[:, 1:] - pe_hyd
        nh = {
            "delz_c_max": float(half.delz_c[i].max()),
            "dzh_min": float((zh[:, :-1] - zh[:, 1:]).min()),
            "zs_pin_err": float((half.zh_c[i][:, -1] - half.zh_x[i][:, -1]).abs().max()),
            "zs_err": float((zh[:, -1] - case.state.phis[i].double() / constants.GRAV)
                            .abs().max()),
            "ws_max": float(half.ws_c[i].abs().max()),
            "pp_rel_max": float((pp.abs() / pe_hyd).max()),
        }
    return {
        **nh,
        "finite": all(bool(torch.isfinite(t[i]).all()) for t in outputs),
        "delpc_min": float(delpc.min()),
        "mass_drift": float((m1 - m0).abs() / m0),
        "ptc_min": float(ptc.min()),
        "ptc_max": float(ptc.max()),
        "pt_floor": float(pt.min()) - 1e-3 * pt_rng,
        "pt_ceil": float(pt.max()) + 1e-3 * pt_rng,
        "pkz_min": float(pkz.min()),
        "pkz_max": float(pkz.max()),
        "uc_max": float(half.uc_x[i].abs().max()),
    }


def steady_state_residual(n: int = 48, npz: int = 8, device="cuda",
                          dtype=torch.float32, hydrostatic: bool = True) -> dict:
    """Balance check on the unperturbed state, a steady solution of the
    hydrostatic equations: the C-grid wind tendency over the half step,
    ``(uc_out - uc_in) / dt2``, against the pressure-gradient term alone,
    as root-mean-square values over the compute domain. Their ratio is small
    when the momentum terms of ``c_sw`` balance ``p_grad_c``; in the
    nonhydrostatic configuration (``w = 0`` and ``delz`` in hydrostatic
    balance) it also needs the vertical solve to leave the column at rest."""
    case = build_case(n, npz, device, dtype, perturbation=False, hydrostatic=hydrostatic)
    half = step(case)
    _ua, _va, uc_in, vc_in, _ut, _vt = d2a2c_vect(half.u_y, half.v_x, case.grid)
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))

    def rms(*ts):
        return float(torch.sqrt(sum((t[i].double() ** 2).mean() for t in ts) / len(ts)))

    tend = rms((half.uc_x - uc_in) / case.dt2, (half.vc_y - vc_in) / case.dt2)
    pgf = rms((half.uc_x - half.cg.uc) / case.dt2, (half.vc_y - half.cg.vc) / case.dt2)
    return {"tendency_rms": tend, "pgf_rms": pgf, "ratio": tend / pgf}


def run(n: int = 48, npz: int = 8, repeats: int = 3, device="cuda",
        dtype=torch.float32, hydrostatic: bool = True) -> dict:
    """Build the case and take ``repeats`` half steps from its state.
    Returns the last result, the wall ms of each repeat, ms per half step
    over the repeats after the first (the first also builds the halo index
    maps), on a card the number of device allocations (``cudaMalloc`` calls
    of PyTorch's caching allocator) each repeat made, and
    :func:`diagnostics`."""
    case = build_case(n, npz, device, dtype, hydrostatic=hydrostatic)
    dev = case.state.u.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def n_device_allocs():
        return torch.cuda.memory_stats(dev).get("num_device_alloc", 0) if on_card else 0

    step_ms, device_allocs = [], []
    half = None
    for _ in range(repeats):
        sync()
        a0 = n_device_allocs()
        t0 = time.perf_counter()
        half = step(case)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        device_allocs.append(n_device_allocs() - a0)
    steady = step_ms[1:] or step_ms
    return {
        "case": case, "half": half, "step_ms": step_ms, "device_allocs": device_allocs,
        "ms_per_half_step": sum(steady) / len(steady),
        **diagnostics(case, half),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    ap.add_argument("--nonhydrostatic", action="store_true",
                    help="carry w and delz and run the nonhydrostatic vertical")
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    hydrostatic = not args.nonhydrostatic
    out = run(args.n, args.npz, args.repeats, args.device, dtype, hydrostatic)
    print(f"C{args.n} npz={args.npz} {'' if hydrostatic else 'non'}hydrostatic: "
          f"{args.repeats} half steps of dt2={DT2:.4f} s, "
          f"{out['ms_per_half_step']:.1f} ms/half step")
    keys = ["finite", "delpc_min", "mass_drift", "ptc_min", "ptc_max", "pkz_min",
            "pkz_max", "uc_max"]
    if not hydrostatic:
        keys += ["delz_c_max", "dzh_min", "zs_pin_err", "zs_err", "ws_max", "pp_rel_max"]
    for k in keys:
        print(f"{k:11s} {out[k]}")
    bal = steady_state_residual(args.n, args.npz, args.device, dtype, hydrostatic)
    print(f"unperturbed state: tendency rms {bal['tendency_rms']:.3e} m/s^2, pressure-"
          f"gradient rms {bal['pgf_rms']:.3e} m/s^2, ratio {bal['ratio']:.3e}")


if __name__ == "__main__":
    main()
