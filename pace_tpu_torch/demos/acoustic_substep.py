"""One acoustic substep, as far as it is ported, from the baroclinic-wave state.

Builds the cubed-sphere grid and the Jablonowski-Williamson (2006) initial
state, then runs ``models.fv3.acoustics.c_grid_half`` and ``d_grid_half``:
the C-grid half step and its pressure gradient, then the D-grid step ``d_sw``
(the delp flux, the multi-field transport of pt / vorticity / w, the
vorticity damping fluxes, the D-grid tail), the dissipation heating and, in
the nonhydrostatic configuration, the advection of the interface heights
(``updatedz_d``) and the vertical solve (``riem_solver3``). The D-grid
pressure gradient, which closes the substep, is not ported yet, so the state
is not advanced and every repeat starts from the initial state.

The configuration is the dycore benchmark's: nonhydrostatic, ``a_imp = 1``,
``p_fac = 0.05``, hord 6, ``nord = 3`` with the tile-edge band, Smagorinsky
and vorticity damping, ``d_con = 1``; the time step its acoustic step, ``dt =
200 s / (k_split 7 * n_split 8)``.

Run::

    python -m pace_tpu_torch.demos.acoustic_substep --n 24 --npz 8 --device cpu
    python -m pace_tpu_torch.demos.acoustic_substep --n 24 --npz 8 --device cpu \
        --f64 --hydrostatic
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
from typing import Tuple

import torch

from .. import constants
from ..models.fv3.acoustics import (
    AcousticConfig,
    CGridHalf,
    DGridHalf,
    c_grid_half,
    d_grid_half,
)
from ..ops.d_sw import DSWConfig
from . import cgrid_half_step as cdemo
from .cgrid_half_step import CGridCase

#: the acoustic time step of the dycore benchmark [s]
DT = 200.0 / (7 * 8)

#: the D-grid solver settings of the dycore benchmark
BENCH_D_SW = DSWConfig(
    hord_mt=6, hord_vt=6, hord_tm=6, hord_dp=6, nord=3, d4_bg=0.15, d2_bg=0.0,
    d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5, do_vort_damp=True, vtdm4=0.06, d_con=1.0,
    damp_w=0.0, edge_damp_band=True, lap_divg_weights=False,
)

#: repeats taken before the timed ones, so that PyTorch's caching allocator
#: holds every block the step needs (a repeat that still calls cudaMalloc
#: can take several times as long on the host's clock)
WARM_REPEATS = 2


def bench_config(hydrostatic: bool = False) -> AcousticConfig:
    """The dycore benchmark's acoustic configuration."""
    return AcousticConfig(hydrostatic=hydrostatic, a_imp=1.0, p_fac=0.05, d_sw=BENCH_D_SW)


def build_case(n: int = 48, npz: int = 8, device="cuda", dtype=torch.float32,
               perturbation: bool = True, hydrostatic: bool = False) -> CGridCase:
    """Generate the C``n`` grid and the baroclinic-wave state on ``device``
    with the benchmark's configuration (``case.dt2`` is half of :data:`DT`)."""
    case = cdemo.build_case(n, npz, device, dtype, perturbation=perturbation,
                            hydrostatic=hydrostatic)
    return dataclasses.replace(case, config=bench_config(hydrostatic), dt2=0.5 * DT)


def step(case: CGridCase) -> Tuple[CGridHalf, DGridHalf]:
    """One C-grid half step, then one D-grid half up to the vertical solve,
    from the case's state."""
    st = case.state
    dt = 2.0 * case.dt2
    w, delz = (None, None) if case.config.hydrostatic else (st.w, st.delz)
    chalf = c_grid_half(
        st.u, st.v, w, st.delp, st.pt, delz, st.phis, case.grid, case.halo,
        case.config, case.dt2, case.grid.ptop, phis_folds=case.phis_folds,
    )
    dhalf = d_grid_half(chalf, case.grid, case.halo, case.config, dt, case.grid.ptop, st.phis)
    return chalf, dhalf


def diagnostics(case: CGridCase, chalf: CGridHalf, dhalf: DGridHalf) -> dict:
    """Conservation and range measures of the D-grid half on the compute
    domain, in float64.

    ``mass_drift``, ``theta_drift`` and ``w_drift``: relative change of
    ``sum(delp area)``, ``sum(pt delp area)`` (before the heating) and
    ``sum(w delp area)`` across ``d_sw``, which is flux-form with synced
    interfaces, so they are round-off (``w_drift`` is relative to the total
    mass times the largest ``|w|``, 1 m/s at least: the analytic state has ``w
    = 0``). ``dT_max``: the largest heating increment [K], against its cap
    ``dT_cap = delt_max |dt|``. Nonhydrostatic only: ``delz_max`` (must stay
    negative), ``zs_err`` (bottom interface of ``gz`` against ``phis``, in
    m), ``pp_rel_max`` (largest perturbation pressure relative to the
    hydrostatic interface pressure) and ``ws_max`` [m/s]."""
    cfg = case.config
    dt = 2.0 * case.dt2
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))
    st, ds = case.state, dhalf.ds
    area = case.grid.area[i].double()[:, None]
    delp0, pt0 = st.delp[i].double(), st.pt[i].double()
    delp1, pt1 = ds.delp[i].double(), ds.pt[i].double()
    m0 = (delp0 * area).sum()
    th0 = (pt0 * delp0 * area).sum()
    outputs = [dhalf.u, dhalf.v, dhalf.delp, dhalf.pt, dhalf.mfx, dhalf.mfy, dhalf.crx,
               dhalf.cry, dhalf.xfx, dhalf.yfx]
    out = {
        "delp_min": float(delp1.min()),
        "mass_drift": float(((delp1 * area).sum() - m0).abs() / m0),
        "theta_drift": float(((pt1 * delp1 * area).sum() - th0).abs() / th0),
        "pt_min": float(dhalf.pt[i].min()),
        "pt_max": float(dhalf.pt[i].max()),
        "u_max": float(dhalf.u[i].abs().max()),
        "dT_cap": cfg.delt_max * abs(dt),
    }
    if dhalf.heat is not None:
        outputs.append(dhalf.heat)
        d_pt = (dhalf.pt[i].double() - pt1) * chalf.pkz_c[i].double()
        out["dT_max"] = float(d_pt.abs().max())
        out["heat_max"] = float(dhalf.heat[i].abs().max())
    if not cfg.hydrostatic:
        outputs += [dhalf.w, dhalf.delz, dhalf.pp, dhalf.pk, dhalf.pkz, dhalf.gz, dhalf.ws]
        w0, w1 = st.w[i].double(), ds.w[i].double()
        w_scale = m0 * max(float(w0.abs().max()), 1.0)
        pe = case.grid.ptop + torch.cumsum(dhalf.delp[i].double(), dim=1)
        out.update({
            "w_drift": float(((w1 * delp1 * area).sum() - (w0 * delp0 * area).sum()).abs()
                             / w_scale),
            "delz_max": float(dhalf.delz[i].max()),
            "zs_err": float((dhalf.gz[i][:, -1].double() - st.phis[i].double()).abs().max()
                            / constants.GRAV),
            "pp_rel_max": float((dhalf.pp[i].double()[:, 1:].abs() / pe).max()),
            "ws_max": float(dhalf.ws[i].abs().max()),
            "w_max": float(dhalf.w[i].abs().max()),
        })
    out["finite"] = all(bool(torch.isfinite(t[i]).all()) for t in outputs)
    return out


def steady_state_residual(n: int = 48, npz: int = 8, device="cuda",
                          dtype=torch.float32, hydrostatic: bool = False) -> dict:
    """Balance check of the D-grid step on the unperturbed state, a steady
    solution: there the D-grid pressure gradient, which is not ported yet,
    must cancel the wind change that ``d_sw`` makes (Coriolis force and
    kinetic-energy gradient), so that change, as a tendency, has the size of
    the pressure-gradient term. Returns the root-mean-square D-grid wind
    tendency of ``d_sw`` over the compute domain, the rms C-grid
    pressure-gradient term of the same substep, and their ratio, which is
    close to 1 when the D-grid momentum terms are right (a missing term
    or a wrong flux gives a ratio far from 1)."""
    case = build_case(n, npz, device, dtype, perturbation=False, hydrostatic=hydrostatic)
    chalf, dhalf = step(case)
    h = case.grid.n_halo
    i = (..., slice(h, -h), slice(h, -h))
    dt = 2.0 * case.dt2

    def rms(*ts):
        return float(torch.sqrt(sum((t[i].double() ** 2).mean() for t in ts) / len(ts)))

    tend = rms((dhalf.u - chalf.u_y) / dt, (dhalf.v - chalf.v_x) / dt)
    pgf = rms((chalf.uc_x - chalf.cg.uc) / case.dt2, (chalf.vc_y - chalf.cg.vc) / case.dt2)
    return {"tendency_rms": tend, "pgf_rms": pgf, "ratio": tend / pgf}


def run(n: int = 48, npz: int = 8, repeats: int = 3, device="cuda",
        dtype=torch.float32, hydrostatic: bool = False) -> dict:
    """Build the case and take :data:`WARM_REPEATS` untimed and ``repeats``
    timed substeps from its state. Returns the last results, the wall ms of
    each timed repeat with their mean and median, on a card the number of
    device allocations (``cudaMalloc`` calls of PyTorch's caching allocator)
    each timed repeat made, and :func:`diagnostics`."""
    case = build_case(n, npz, device, dtype, hydrostatic=hydrostatic)
    (chalf, dhalf), step_ms, device_allocs = cdemo.timed_repeats(
        lambda: step(case), repeats, case.state.u.device, warm=WARM_REPEATS)
    return {
        "case": case, "chalf": chalf, "dhalf": dhalf, "step_ms": step_ms,
        "device_allocs": device_allocs,
        "ms_per_substep": sum(step_ms) / len(step_ms),
        "ms_median": statistics.median(step_ms),
        **diagnostics(case, chalf, dhalf),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, help="cells per tile edge")
    ap.add_argument("--npz", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 instead of float32")
    ap.add_argument("--hydrostatic", action="store_true",
                    help="the hydrostatic configuration: no w, no delz, no vertical solve")
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    out = run(args.n, args.npz, args.repeats, args.device, dtype, args.hydrostatic)
    print(f"C{args.n} npz={args.npz} {'' if args.hydrostatic else 'non'}hydrostatic: "
          f"{args.repeats} substeps of dt={DT:.4f} s after {WARM_REPEATS} warm ones, "
          f"{out['ms_per_substep']:.1f} ms/substep (median {out['ms_median']:.1f})")
    keys = ["finite", "delp_min", "mass_drift", "theta_drift", "pt_min", "pt_max", "u_max",
            "heat_max", "dT_max", "dT_cap"]
    if not args.hydrostatic:
        keys += ["w_drift", "delz_max", "zs_err", "pp_rel_max", "ws_max", "w_max"]
    for k in keys:
        print(f"{k:11s} {out[k]}")
    bal = steady_state_residual(args.n, args.npz, args.device, dtype, args.hydrostatic)
    print(f"unperturbed state: d_sw wind tendency rms {bal['tendency_rms']:.3e} m/s^2, C-grid "
          f"pressure-gradient rms {bal['pgf_rms']:.3e} m/s^2, ratio {bal['ratio']:.3e}")


if __name__ == "__main__":
    main()
