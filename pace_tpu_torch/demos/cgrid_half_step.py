"""The C-grid half of one acoustic substep from the baroclinic-wave state.

Builds the cubed-sphere grid and the Jablonowski-Williamson (2006) initial
state, then runs ``models.fv3.acoustics.c_grid_half`` in the hydrostatic
configuration: the substep's halo exchanges, ``c_sw`` (d2a2c, the C-grid
tail), the hydrostatic interface chain, ``p_grad_c`` and the exchange of the
resulting C-grid winds. The time step is the dycore benchmark's acoustic
step, ``dt = 200 s / (k_split 7 * n_split 8)``, so ``dt2 = dt / 2``.

Every repeat starts from the same initial state (the D-grid half that would
advance it is not ported yet), so repeats time the same work.

Run::

    python -m pace_tpu_torch.demos.cgrid_half_step --n 24 --npz 8 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

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


def build_case(n: int = 48, npz: int = 8, device="cuda", dtype=torch.float32,
               perturbation: bool = True) -> CGridCase:
    """Generate the C``n`` grid and the baroclinic-wave state on ``device``."""
    dev = resolve_device(device)
    check_dtype(dtype)
    mt = MetricTerms.generate(GridSpec(n_tile=n, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device=dev, dtype=dtype)
    state = DycoreState.from_baroclinic_init(
        mt, perturbation=perturbation, device=dev, dtype=dtype
    )
    return CGridCase(grid=grid, halo=mt.halo, state=state, config=AcousticConfig())


def step(case: CGridCase) -> CGridHalf:
    """One C-grid half step from the case's state."""
    st = case.state
    return c_grid_half(
        st.u, st.v, None, st.delp, st.pt, None, st.phis, case.grid, case.halo,
        case.config, case.dt2, case.grid.ptop,
    )


def diagnostics(case: CGridCase, half: CGridHalf) -> dict:
    """Conservation and range measures on the compute domain, in float64."""
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))
    area = case.grid.area[i].double()[:, None]
    delp, pt = case.state.delp[i].double(), case.state.pt[i].double()
    delpc, ptc = half.cg.delpc[i].double(), half.cg.ptc[i].double()
    pkz = half.pkz_c[i]
    m0, m1 = (delp * area).sum(), (delpc * area).sum()
    pt_rng = float(pt.max() - pt.min())
    outputs = (half.cg.delpc, half.cg.ptc, half.cg.divg_d, half.uc_x, half.vc_x,
               half.uc_y, half.vc_y, half.pkz_c)
    return {
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
                          dtype=torch.float32) -> dict:
    """Balance check on the unperturbed state, a steady solution of the
    hydrostatic equations: the C-grid wind tendency over the half step,
    ``(uc_out - uc_in) / dt2``, against the pressure-gradient term alone,
    as root-mean-square values over the compute domain. Their ratio is small
    when the momentum terms of ``c_sw`` balance ``p_grad_c``."""
    case = build_case(n, npz, device, dtype, perturbation=False)
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
        dtype=torch.float32) -> dict:
    """Build the case and take ``repeats`` half steps from its state.
    Returns the last result, the wall ms of each repeat, ms per half step
    over the repeats after the first (the first also builds the halo index
    maps) and :func:`diagnostics`."""
    case = build_case(n, npz, device, dtype)
    sync = torch.cuda.synchronize if case.state.u.is_cuda else (lambda: None)
    step_ms = []
    half = None
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        half = step(case)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    steady = step_ms[1:] or step_ms
    return {
        "case": case, "half": half, "step_ms": step_ms,
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
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    out = run(args.n, args.npz, args.repeats, args.device, dtype)
    print(f"C{args.n} npz={args.npz}: {args.repeats} half steps of dt2={DT2:.4f} s, "
          f"{out['ms_per_half_step']:.1f} ms/half step")
    for k in ("finite", "delpc_min", "mass_drift", "ptc_min", "ptc_max", "pkz_min",
              "pkz_max", "uc_max"):
        print(f"{k:11s} {out[k]}")
    bal = steady_state_residual(args.n, args.npz, args.device, dtype)
    print(f"unperturbed state: tendency rms {bal['tendency_rms']:.3e} m/s^2, pressure-"
          f"gradient rms {bal['pgf_rms']:.3e} m/s^2, ratio {bal['ratio']:.3e}")


if __name__ == "__main__":
    main()
