#!/usr/bin/env python3
"""Time an earlier revision's remap, nh_p_grad, sim1, multi-field transport,
tracer-block transport, single-field transport, D-grid tail, C-grid tail,
d2a2c, hydrostatic-chain and updatedz_c kernels against the current ones on
one NVIDIA card, in turns, at the dycore step's shapes.

Run from the repository root on a machine with a card and ``nvcc``::

    mkdir -p build/prev
    for f in remap pgrad sim1 fvtp2d d_sw_tail c_sw_tail d2a2c hydro updatedz; do
        git show <rev>:pace_tpu_torch/csrc/$f.cu > build/prev/$f.cu
    done
    python3 tools/torch_kernel_ab.py --prev build/prev [--kernels d2a2c,hydro]

``--kernels`` picks from ``remap, pgrad, sim1, fvtp2d, tracer, single,
d_sw_tail, c_sw_tail, d2a2c, hydro, updatedz_c, halo`` (default all); the
earlier directory needs the sources of the kernels picked (``fvtp2d.cu`` for
``fvtp2d``, ``tracer`` and ``single``, ``updatedz.cu`` for ``updatedz_c``). The earlier sources must export the C functions the current
wrappers call (``pace_remap_f32`` ..., ``pace_pgrad_f32`` ...,
``pace_sim1_f32`` ..., ``pace_fvtp2d_f32`` ..., ``pace_fvtp2d_multi_f32``
..., ``pace_d_sw_tail_f32`` ..., ``pace_c_sw_tail_f32`` ..., ``pace_d2a2c_f32``
..., ``pace_hydro_f32`` ..., ``pace_updatedz_c_f32`` ...) with the
current arguments; the earlier tracer block is the earlier
``pace_fvtp2d_f32`` / ``_f64`` with NQ tracers (the design before the tracer
kernel: one block per tracer), the current one ``pace_fvtp2d_tracer_f32`` /
``_f64``. Both revisions
are built with ``_build.NVCC_FLAGS`` and their ``-Xptxas -v`` lines printed
(the earlier ones into ``build/kernels/prev``, which ``.gitignore`` lists).
Each kernel then runs through its own wrapper on the same inputs, C192
npz=79 f32 by default, in the order earlier, current, current, earlier:
CUDA-event means of 20 launches (the tracer block 5), the bytes of the
kernel's bound over its time, and whether the two revisions give the same
bits. The pgrad inputs are one acoustic substep's
(``demos/acoustic_substep``), the remap's the pressure columns after one
acoustic loop of the dycore step, as in ``chip_smoke.py``. sim1 takes
``chip_smoke.py``'s C-grid operands (one nonhydrostatic C-grid half step,
as ``riem_solver_c`` calls it; ``riem_solver3`` calls it at the same
shapes), the multi-field transport d_sw's pt / vorticity / w of one acoustic
substep; both also in float64 on the same inputs (means of 5 launches). The
tracer block takes ``chip_smoke.py``'s nine tracers (hord 8, the corner
pack, mass-flux weights; means of 5 launches in float32, 2 in float64). The
single-field transport takes its two calls of one acoustic substep: d_sw's
delp mass fluxes (hord 6, the corner pack, K = npz) and updatedz_d's
interface heights (hord 5, a full qy, K = npz + 1), both weighted by the area
fluxes. The C-grid tail takes the operands of one C-grid half step from the
baroclinic-wave state, as ``chip_smoke.py`` builds them. The D-grid tail takes ``chip_smoke.py``'s two tail cases
on one acoustic substep's fields (the benchmark's nord 3 with every switch
on; nord 1 without band, heat or vorticity damping), in float32 and on the
same inputs in float64 (with a float64 copy of the grid). d2a2c takes the
D-grid winds of the baroclinic-wave state after their exchange, the
hydrostatic chain one C-grid tail's delpc and ptc in each form a step
launches (``chip_smoke.HYDRO_FORMS``: pkz, pk and pkz, pk, pkz and gz); both
in float32 (timed) and float64 (the bits, 5 launches, d2a2c with a float64
copy of the grid). updatedz_c takes one nonhydrostatic C-grid half step's
interface heights (both folds) and c_sw's layer area fluxes, as
``chip_smoke.py`` builds them, timed in float32 and float64 (20 launches
each).

With ``halo`` picked, the halo exchange plan that launches most often in one
dycore step (``demos/dycore_step``, with a seeded tracer block): launches
per step by plan, that plan's time per call and per launch, its bound, and
one ``torch.take`` per output over the inputs and their negatives laid end
to end (built before the timing), checked equal to the plain exchange.

Prints ``[build]``, ``[ab]`` and ``[halo]`` lines and the card's name and
power limit (``nvidia-smi``). Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the timing and bound helpers)
from pace_tpu_torch import _build  # noqa: E402

log = chip_smoke.log
time_ms = chip_smoke.time_ms
nbytes = chip_smoke.nbytes

KERNELS = ("remap", "pgrad", "sim1", "fvtp2d", "tracer", "single", "d_sw_tail", "c_sw_tail",
           "d2a2c", "hydro", "updatedz_c")
#: the hydrostatic chain's forms a step launches
HYDRO_FORMS = chip_smoke.HYDRO_FORMS
#: the kernel library each pick builds (the tracer and single-field kernels
#: live in fvtp2d.cu, updatedz_c in updatedz.cu)
LIBRARY = {"tracer": "fvtp2d", "single": "fvtp2d", "updatedz_c": "updatedz"}


def build_prev(prev_dir: str, names):
    """The earlier sources built with the current flags: ``{name: CDLL}``."""
    out_dir = _build.BUILD_DIR / "prev"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = out_dir / f"libprev_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
               os.path.join(prev_dir, _build.SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"earlier {name} failed to build:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] earlier {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def in_turns(label, libs, name, call, reps, moved):
    """``call`` with the earlier and the current library of ``name`` in
    turns; logs the times and whether the outputs agree bit for bit.
    ``call`` may return a tensor or a (nested) sequence of tensors; it may
    also be ``{"earlier": fn, "current": fn}`` where the two revisions are
    reached through different entries."""
    order = ("earlier", "current", "current", "earlier")
    outs, times = {}, []
    for which in order:
        _build._LIBS[name] = libs[which]
        fn = call[which] if isinstance(call, dict) else call
        outs.setdefault(which, fn())
        times.append(time_ms(fn, reps))
    _build._LIBS[name] = libs["current"]
    a, b = flat(outs["earlier"]), flat(outs["current"])
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    earlier = (times[0] + times[3]) / 2
    current = (times[1] + times[2]) / 2
    log(f"[ab] {label}: earlier {times[0]:.4f} / {times[3]:.4f} ms, current {times[1]:.4f} / "
        f"{times[2]:.4f} ms (in the order earlier, current, current, earlier), "
        f"{earlier / current:.2f}x; {moved / current / 1e6:.1f} GB/s of the bound's bytes "
        f"(earlier {moved / earlier / 1e6:.1f}); outputs bit-identical: {same}")
    return same


def flat(out):
    """The tensors of a (nested) sequence, in order."""
    if torch.is_tensor(out):
        return [out]
    return [t for o in out if o is not None for t in flat(o)]


def build_both(prev_dir, names):
    """Both revisions of ``names``: ``{name: {"earlier": CDLL, "current": CDLL}}``."""
    t0 = time.perf_counter()
    _build.build(list(names))
    for name in names:
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] current {name}: {line.strip()}")
    prev = build_prev(prev_dir, names)
    log(f"[build] both revisions in {time.perf_counter() - t0:.1f} s")
    return {name: {"earlier": prev[name], "current": _build.library(name)} for name in names}


def sim1_operands(n, npz, dev):
    """chip_smoke.py's C-grid sim1 operands, as riem_solver_c passes them
    after one nonhydrostatic C-grid half step: ``(w, delz, pt, delp, pkz,
    ws), dt2, ptop, p_fac``."""
    from pace_tpu_torch.demos import cgrid_half_step as cdemo

    ncase = cdemo.build_case(n, npz, device=dev, dtype=torch.float32, hydrostatic=False)
    nhalf = cdemo.step(ncase)
    zh = nhalf.zh_c
    s_args = (nhalf.w_x, zh[:, 1:] - zh[:, :-1], nhalf.cg.ptc, nhalf.cg.delpc, nhalf.pkz_c,
              nhalf.ws_c)
    return s_args, ncase.dt2, ncase.grid.ptop, ncase.config.p_fac


def transport_operands(n, npz, dev, singles=False):
    """d_sw's pt / vorticity / w of one acoustic substep and their shared
    operands ``(crx, cry, xfx, yfx, area, mfx, mfy)``, as chip_smoke.py
    builds them; with ``singles``, instead the arguments of the substep's two
    single-field calls (``fvtp2d_cuda``): ``{"delp": ..., "heights": ...}``."""
    from pace_tpu_torch.demos import acoustic_substep as sdemo
    from pace_tpu_torch.ops import d_sw as d_sw_ops
    from pace_tpu_torch.ops.folds import CornerPatch
    from pace_tpu_torch.ops.fvtp2d import fvtp2d_best
    from pace_tpu_torch.ops.fxadv import flux_prep_x, flux_prep_y

    scase = sdemo.build_case(n, npz, device=dev, dtype=torch.float32)
    sgrid, shalo, scfg = scase.grid, scase.halo, scase.config.d_sw
    dt = 2.0 * scase.dt2
    chalf, _dhalf = sdemo.step(scase)
    crx, xfx, _ut = flux_prep_x(chalf.uc_x, chalf.vc_x, sgrid, dt)
    cry, yfx, _vt = flux_prep_y(chalf.uc_y, chalf.vc_y, sgrid, dt)
    vort = d_sw_ops.absolute_vorticity_centers(chalf.u_y, chalf.v_x, sgrid)
    vort_x, vort_p = shalo.update_scalar_fold_patch(vort)
    if singles:
        from pace_tpu_torch.ops.nonhydro import _to_iface

        return {"delp": (chalf.delp_x, chalf.delp_y, crx, cry, xfx, yfx, sgrid.area,
                         scfg.hord_dp),
                "heights": (chalf.zh_x, chalf.zh_y, *(_to_iface(t) for t in (crx, cry, xfx, yfx)),
                            sgrid.area, 5)}
    fl = fvtp2d_best(chalf.delp_x, chalf.delp_y, crx, cry, xfx, yfx, sgrid.area, scfg.hord_dp)
    mfx, mfy = shalo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    trio = [(chalf.pt_x, chalf.pt_y, scfg.hord_tm, True),
            (vort_x, CornerPatch(vort_p), scfg.hord_vt, False),
            (chalf.w_x, chalf.w_y, scfg.hord_vt, True)]
    return trio, (crx, cry, xfx, yfx, sgrid.area, mfx, mfy)


def sim1_and_multi(libs, n, npz, dev):
    """sim1 on chip_smoke.py's C-grid operands and the multi-field transport
    on d_sw's trio, in float32 (timed) and float64 (the bits)."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops import sim1_kernel as s1k
    from pace_tpu_torch.ops.folds import CornerPatch

    f32, f64 = torch.float32, torch.float64
    ok = True
    if "sim1" in libs:
        s_args, dt2, ptop, p_fac = sim1_operands(n, npz, dev)
        for dtype, reps in ((f32, 20), (f64, 5)):
            args = [t.to(dtype).contiguous() for t in s_args]
            S, K, Y, X = args[0].shape
            tc = s1k.tile_columns(K, dtype)
            out_bytes = (2 * K + K + 1) * S * Y * X * args[0].element_size()  # w, delz, pp
            ok &= in_turns(f"sim1 {tuple(args[0].shape)} {str(dtype)[6:]} ({tc} columns a "
                           f"block)", libs["sim1"], "sim1",
                           lambda: s1k.sim1_solver_cuda(*args, dt2, ptop, p_fac=p_fac), reps,
                           nbytes(*args) + out_bytes)
            del args
        del s_args
        torch.cuda.empty_cache()
    if "fvtp2d" in libs:
        trio, ops = transport_operands(n, npz, dev)
        for dtype, reps in ((f32, 20), (f64, 5)):
            o = [t.to(dtype).contiguous() for t in ops]
            fields = [(qx.to(dtype), CornerPatch(qy.data.to(dtype)), h, m)
                      for qx, qy, h, m in trio]
            q_in = [t for qx, qy, _h, _m in fields for t in (qx, qy.data)]
            moved = nbytes(*o, *q_in) + len(fields) * nbytes(o[0], o[1])  # + fx, fy
            ok &= in_turns(f"fvtp2d multi 3 x {tuple(trio[0][0].shape)} {str(dtype)[6:]} "
                           f"hord {[t[2] for t in trio]}", libs["fvtp2d"], "fvtp2d",
                           lambda: fk.fvtp2d_multi_cuda(fields, *o[:5], mfx=o[5], mfy=o[6]),
                           reps, moved)
            del o, fields
        del trio, ops
        torch.cuda.empty_cache()
    return ok


def tracer_operands(n, npz, dev):
    """chip_smoke.py's tracer block and the single-field ``delp`` call, in
    float32: ``(tracer_args, single_args)``, the arguments of
    ``fvtp2d_tracer_cuda`` (nine tracers, the corner pack, hord 8) and of
    ``fvtp2d_cuda`` (hord 6)."""
    from pace_tpu_torch.demos import tracer_advection as demo
    from pace_tpu_torch.ops.folds import CornerPatch
    from pace_tpu_torch.ops.fvtp2d import fvtp2d_best
    from pace_tpu_torch.ops.tracer_advection import subcycle_count

    case = demo.build_case(n, npz, chip_smoke.NQ, chip_smoke.DT, device=dev,
                           dtype=torch.float32)
    grid = case.grid
    frac = 1.0 / subcycle_count(case.crx, case.cry, grid.n_halo)
    dpx, dpp = case.halo.update_scalar_fold_patch(case.delp)
    fl = fvtp2d_best(dpx, CornerPatch(dpp), case.crx, case.cry, case.xfx, case.yfx,
                     grid.area, 6)
    mfx, mfy = case.halo.sync_vector_interfaces(fl.fx, fl.fy, kind="cgrid")
    ops = [t * frac for t in (case.crx, case.cry, case.xfx, case.yfx)] + [grid.area]
    qx, qp = case.halo.update_scalar_fold_patch(case.q)
    return ((qx, CornerPatch(qp), *ops, mfx * frac, mfy * frac, 8),
            (dpx, CornerPatch(dpp), *ops, 6))


def tracer_block(libs, n, npz, dev):
    """The tracer block of chip_smoke.py: the earlier one-block-per-tracer
    launch against the tracer kernel, in float32 (timed) and float64 (the
    bits)."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops.folds import CornerPatch

    targs, _single = tracer_operands(n, npz, dev)
    ok = True
    for dtype, reps in ((torch.float32, 5), (torch.float64, 2)):
        qx, qp = targs[0].to(dtype), targs[1].data.to(dtype)
        o = [t.to(dtype) for t in targs[2:9]]
        args = (qx, CornerPatch(qp), *o, 8)
        calls = {"earlier": lambda: fk._launch(*args),
                 "current": lambda: fk.fvtp2d_tracer_cuda(*args)}
        moved = nbytes(qx, qp, *o) + qx.shape[1] * nbytes(o[0], o[1])  # + fx, fy
        ok &= in_turns(f"fvtp2d tracer block {tuple(qx.shape)} {str(dtype)[6:]} hord 8",
                       libs["fvtp2d"], "fvtp2d", calls, reps, moved)
        del qx, qp, o, args, calls
        torch.cuda.empty_cache()
    return ok


def single_transport(libs, n, npz, dev):
    """The substep's two single-field calls, earlier against current, in
    float32 (timed, 20 launches) and float64 (the bits, 5)."""
    from pace_tpu_torch.ops import fvtp2d_kernel as fk
    from pace_tpu_torch.ops.folds import CornerPatch

    ok = True
    for label, args in transport_operands(n, npz, dev, singles=True).items():
        patch = isinstance(args[1], CornerPatch)
        for dtype, reps in ((torch.float32, 20), (torch.float64, 5)):
            qy = args[1].data.to(dtype) if patch else args[1].to(dtype)
            a = (args[0].to(dtype), CornerPatch(qy) if patch else qy,
                 *(t.to(dtype) for t in args[2:7]), args[7])
            moved = nbytes(a[0], qy, *a[2:7]) + nbytes(a[2], a[3])  # + fx, fy
            ok &= in_turns(f"fvtp2d single field, {label} {tuple(a[0].shape)} "
                           f"{str(dtype)[6:]} hord {args[7]} "
                           f"({'the corner pack' if patch else 'a full qy'})",
                           libs["fvtp2d"], "fvtp2d", lambda: fk.fvtp2d_cuda(*a), reps, moved)
            del a, qy
            torch.cuda.empty_cache()
    return ok


def c_sw_tail_operands(n, npz, dev, phis=False):
    """The C-grid tail's arguments after one d2a2c and its exchanges from the
    baroclinic-wave state, as chip_smoke.py builds them: those of
    ``c_sw_tail_cuda`` (with ``phis``, also the state's surface
    geopotential)."""
    from pace_tpu_torch.demos import cgrid_half_step as cdemo
    from pace_tpu_torch.ops import d2a2c_kernel as d2k

    ccase = cdemo.build_case(n, npz, device=dev, dtype=torch.float32)
    grid, halo, st = ccase.grid, ccase.halo, ccase.state
    u_y, v_x = halo.update_vector_fold_pair(st.u, st.v, kind="dgrid")
    (delp_x, _), (pt_x, _) = halo.update_scalars_fold_patches([st.delp, st.pt])
    ua, va, uc, vc, _ut, _vt = d2k.d2a2c_cuda(u_y, v_x, grid)
    uc, vc = halo.sync_vector_interfaces(uc, vc, kind="cgrid")
    uc_x, vc_x = halo.update_vector(uc, vc, kind="cgrid", fold="x")
    uc_y, vc_y = halo.update_vector(uc, vc, kind="cgrid", fold="y")
    ua_y, va_x = halo.update_vector_fold_pair(ua, va, kind="agrid")
    args = (u_y, v_x, delp_x, pt_x, uc, vc, uc_x, vc_x, uc_y, vc_y, ua, va, va_x, ua_y, grid,
            ccase.dt2)
    return (args, st.phis) if phis else args


def d2a2c_operands(n, npz, dev):
    """d2a2c's arguments on the baroclinic-wave state, as chip_smoke.py
    builds them: ``(u_y, v_x, grid)``."""
    from pace_tpu_torch.demos import cgrid_half_step as cdemo

    ccase = cdemo.build_case(n, npz, device=dev, dtype=torch.float32)
    u_y, v_x = ccase.halo.update_vector_fold_pair(ccase.state.u, ccase.state.v, kind="dgrid")
    return u_y, v_x, ccase.grid


def hydro_operands(n, npz, dev):
    """The hydrostatic chain's arguments after one C-grid tail from the
    baroclinic-wave state, as chip_smoke.py builds them: ``(delpc, ptc,
    phis, ptop)``."""
    from pace_tpu_torch.ops import c_sw_tail_kernel as ck

    args, phis = c_sw_tail_operands(n, npz, dev, phis=True)
    delpc, ptc = ck.c_sw_tail_cuda(*args)[:2]
    return delpc, ptc, phis, args[14].ptop


def updatedz_c_operands(n, npz, dev):
    """updatedz_c's arguments after one nonhydrostatic C-grid half step from
    the baroclinic-wave state, as chip_smoke.py builds them: ``(zh_x, zh_y,
    xfx, yfx, area, dt2)``."""
    from pace_tpu_torch.demos import cgrid_half_step as cdemo

    ncase = cdemo.build_case(n, npz, device=dev, dtype=torch.float32, hydrostatic=False)
    nhalf = cdemo.step(ncase)
    return nhalf.zh_x, nhalf.zh_y, nhalf.cg.xfx, nhalf.cg.yfx, ncase.grid.area, ncase.dt2


def updatedz_c(libs, n, npz, dev):
    """updatedz_c, earlier against current, in float32 and float64 (both
    timed, 20 launches)."""
    from pace_tpu_torch.ops import updatedz_kernel as uzk

    u_args = updatedz_c_operands(n, npz, dev)
    dt2 = u_args[5]
    ok = True
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype).contiguous() for t in u_args[:5]]
        outs = uzk.updatedz_c_cuda(*a, dt2)
        ok &= in_turns(f"updatedz_c {tuple(a[0].shape)} {str(dtype)[6:]}", libs["updatedz"],
                       "updatedz", lambda: uzk.updatedz_c_cuda(*a, dt2), 20, nbytes(*a, *outs))
        del a, outs
        torch.cuda.empty_cache()
    return ok


def d2a2c(libs, n, npz, dev):
    """d2a2c, earlier against current, in float32 (timed, 20 launches) and
    float64 (the bits, 5, with a float64 copy of the grid)."""
    from pace_tpu_torch.ops import d2a2c as d2a2c_ops
    from pace_tpu_torch.ops import d2a2c_kernel as d2k

    u_y, v_x, grid = d2a2c_operands(n, npz, dev)
    ok = True
    for dtype, reps in ((torch.float32, 20), (torch.float64, 5)):
        g = grid if dtype == torch.float32 else grid_as(grid, dtype)
        u, v = u_y.to(dtype), v_x.to(dtype)
        outs = d2k.d2a2c_cuda(u, v, g)
        consts = [getattr(g, f) for f in d2a2c_ops.GRID_FIELDS]
        ok &= in_turns(f"d2a2c {tuple(u.shape)} {str(dtype)[6:]}", libs["d2a2c"], "d2a2c",
                       lambda: d2k.d2a2c_cuda(u, v, g), reps, nbytes(u, v, *consts, *outs))
        del u, v, outs
        torch.cuda.empty_cache()
    return ok


def hydro(libs, n, npz, dev):
    """The hydrostatic chain, earlier against current, in each of
    ``HYDRO_FORMS``: float32 (timed, 20 launches) and float64 (the bits,
    5)."""
    from pace_tpu_torch.ops import hydro_kernel as hyk

    delpc, ptc, phis, ptop = hydro_operands(n, npz, dev)
    ok = True
    for dtype, reps in ((torch.float32, 20), (torch.float64, 5)):
        d, p, ph = delpc.to(dtype), ptc.to(dtype), phis.to(dtype)
        for need in HYDRO_FORMS:
            outs = hyk.hydrostatic_interfaces_cuda(d, p, ph, ptop, need=need)
            reads = (d, p, ph) if "gz" in need else (d,)
            ok &= in_turns(f"hydro need={need} {tuple(d.shape)} {str(dtype)[6:]}", libs["hydro"],
                           "hydro", lambda: hyk.hydrostatic_interfaces_cuda(d, p, ph, ptop,
                                                                           need=need),
                           reps, nbytes(*reads, *(o for o in outs if o is not None)))
        del d, p, ph, outs
        torch.cuda.empty_cache()
    return ok


def c_sw_tail(libs, n, npz, dev):
    """The C-grid tail, earlier against current, in float32 (timed, 20
    launches) and float64 (the bits, 5, with a float64 copy of the grid)."""
    from pace_tpu_torch.ops import c_sw_tail_kernel as ck

    args = c_sw_tail_operands(n, npz, dev)
    grid = args[14]
    ok = True
    for dtype, reps in ((torch.float32, 20), (torch.float64, 5)):
        g = grid if dtype == torch.float32 else grid_as(grid, dtype)
        a = tuple(t.to(dtype) for t in args[:14]) + (g, args[15])
        outs = ck.c_sw_tail_cuda(*a)
        ok &= in_turns(f"c_sw tail {tuple(a[2].shape)} {str(dtype)[6:]}", libs["c_sw_tail"],
                       "c_sw_tail", lambda: ck.c_sw_tail_cuda(*a), reps,
                       nbytes(*a[:14], *ck.constants(g), *outs))
        del a, outs
        torch.cuda.empty_cache()
    return ok


def tail_operands(n, npz, dev):
    """chip_smoke.py's two D-grid tail cases on one acoustic substep's
    fields: ``[(label, args)]``, ``args`` those of ``d_sw_tail_cuda``."""
    from pace_tpu_torch.demos import acoustic_substep as sdemo
    from pace_tpu_torch.ops import d_sw as d_sw_ops
    from pace_tpu_torch.ops.delnflux import delnflux
    from pace_tpu_torch.ops.folds import CornerPatch
    from pace_tpu_torch.ops.fvtp2d import fvtp2d_best
    from pace_tpu_torch.ops.fxadv import flux_prep_x, flux_prep_y

    scase = sdemo.build_case(n, npz, device=dev, dtype=torch.float32)
    sgrid, shalo, scfg = scase.grid, scase.halo, scase.config.d_sw
    dt = 2.0 * scase.dt2
    chalf, _dhalf = sdemo.step(scase)
    crx, xfx, ut = flux_prep_x(chalf.uc_x, chalf.vc_x, sgrid, dt)
    cry, yfx, vt = flux_prep_y(chalf.uc_y, chalf.vc_y, sgrid, dt)
    vort = d_sw_ops.absolute_vorticity_centers(chalf.u_y, chalf.v_x, sgrid)
    vort_x, vort_p = shalo.update_scalar_fold_patch(vort)
    # the vorticity's fluxes as d_sw forms them (area-flux weights), synced
    vfl = fvtp2d_best(vort_x, CornerPatch(vort_p), crx, cry, xfx, yfx, sgrid.area,
                      scfg.hord_vt)
    vfx, vfy = shalo.sync_vector_interfaces(vfl.fx, vfl.fy, kind="cgrid")
    dvfx, dvfy = delnflux(vort_x, sgrid, min(2, scfg.nord), scfg.vtdm4, sgrid.da_min)
    dvfx, dvfy = shalo.sync_vector_interfaces(dvfx, dvfy, kind="cgrid")
    del vfl, crx, cry, xfx, yfx, scase
    fields = (chalf.u_y, chalf.v_x, ut, vt, chalf.cg.divg_d, vort, vfx, vfy)
    cases = [("nord 3, every switch on", (*fields, dvfx, dvfy, sgrid, dt, scfg)),
             ("nord 1, no band, heat or vorticity damping",
              (*fields, None, None, sgrid, dt,
               d_sw_ops.DSWConfig(nord=1, d4_bg=0.16, dddmp=0.0, d_con=0.0, vtdm4=0.0,
                                  edge_damp_band=False)))]
    return cases


def grid_as(grid, dtype):
    """A copy of ``grid`` with its tensor fields in ``dtype``."""
    import dataclasses

    return dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).to(dtype) for f in dataclasses.fields(grid)
        if torch.is_tensor(getattr(grid, f.name)) and getattr(grid, f.name).is_floating_point()})


def d_sw_tail(libs, n, npz, dev):
    """Both tail cases, earlier against current, in float32 (timed, 20
    launches) and float64 (the bits, 5)."""
    from pace_tpu_torch.ops import d_sw_tail_kernel as dtk
    from pace_tpu_torch.ops.delnflux import lap_corner_weights

    ok = True
    for label, args in tail_operands(n, npz, dev):
        grid = args[10]
        for dtype, reps in ((torch.float32, 20), (torch.float64, 5)):
            g = grid if dtype == torch.float32 else grid_as(grid, dtype)
            a = tuple(None if t is None else t.to(dtype) for t in args[:10]) + (g,) + args[11:]
            outs = [t for t in dtk.d_sw_tail_cuda(*a) if t is not None]
            consts = [getattr(g, c) for c in dtk.CONSTS if not c.startswith("wg")]
            consts += list(lap_corner_weights(g)) + [getattr(g, c) for c in dtk.EDGES]
            ok &= in_turns(f"d_sw tail ({label}) {tuple(a[5].shape)} {str(dtype)[6:]}",
                           libs["d_sw_tail"], "d_sw_tail", lambda: dtk.d_sw_tail_cuda(*a),
                           reps, nbytes(*a[:10], *consts, *outs))
            del a, outs, consts
            torch.cuda.empty_cache()
    return ok


def remap_and_pgrad(libs, n, npz, dev):
    from pace_tpu_torch.demos import acoustic_substep as sdemo
    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.models.fv3.acoustics import acoustic_loop
    from pace_tpu_torch.ops import pgrad_kernel as pgk
    from pace_tpu_torch.ops import remap_kernel as rmk

    f32 = torch.float32
    ok = True
    if "pgrad" in libs:
        scase = sdemo.build_case(n, npz, device=dev, dtype=f32)
        _chalf, dhalf = sdemo.step(scase)
        S, K, Y, X = dhalf.delp.shape
        p_args = (dhalf.u, dhalf.v, dhalf.pk, dhalf.gz, dhalf.pp, dhalf.delp, scase.grid,
                  2.0 * scase.dt2)
        consts = [t for _n, t, _s in pgk.grid_operands(scase.grid, S, Y, X)]
        moved = nbytes(*p_args[:6], *consts, dhalf.u, dhalf.v)
        ok &= in_turns(f"nh_p_grad {tuple(dhalf.delp.shape)} f32", libs["pgrad"], "pgrad",
                       lambda: pgk.nh_p_grad_cuda(*p_args), 20, moved)
        del scase, dhalf, p_args, consts
        torch.cuda.empty_cache()

    if "remap" in libs:
        case = ddemo.build_case(n, npz, device=dev, dtype=f32)
        st, cfg = case.state, case.core.config
        res = acoustic_loop(st.u, st.v, st.w, st.delp, st.pt, st.phis, case.grid, case.halo,
                            cfg.acoustic(), ddemo.TIMESTEP / cfg.k_split, delz=st.delz)
        pe1 = torch.cat([torch.full_like(res.delp[:, :1], case.grid.ptop),
                         case.grid.ptop + torch.cumsum(res.delp, dim=1)], dim=1)
        pe2 = (case.grid.ak[None, :, None, None]
               + case.grid.bk[None, :, None, None] * pe1[:, -1:])
        qblock = chip_smoke.seeded_tracers(st.q, 0)
        ok &= in_turns(f"remap {tuple(res.pt.shape)} f32 kord -9", libs["remap"], "remap",
                       lambda: rmk.remap_cuda(res.pt, pe1, pe2, -9), 20,
                       nbytes(res.pt, pe1, pe2, res.pt))
        ok &= in_turns(f"remap tracer block {tuple(qblock.shape)} f32 kord 9", libs["remap"],
                       "remap", lambda: rmk.remap_cuda(qblock, pe1[:, None], pe2[:, None], 9),
                       5, nbytes(qblock, pe1, pe2, qblock))
    return ok


def halo_census(n, npz, dev):
    from pace_tpu_torch.demos import dycore_step as ddemo
    from pace_tpu_torch.parallel import halo_kernel as hk

    case = ddemo.build_case(n, npz, device=dev, dtype=torch.float32)
    case.state.q = chip_smoke.seeded_tracers(case.state.q, 3)
    case.state = case.core.step_dynamics(case.state)  # warm: plans and maps built
    keys = {id(p): k for k, p in case.core.halo.slabs._plans.items()}
    counts = collections.Counter()
    first = {}
    orig = hk.halo_cuda

    def counting(arrays, plan):
        shapes = tuple(sorted((k, tuple(v.shape)) for k, v in arrays.items()))
        key = (keys.get(id(plan), "unnamed"), shapes)
        counts[key] += len(plan.outputs)
        if key not in first:
            first[key] = (plan, {k: v.clone() for k, v in arrays.items()})
        return orig(arrays, plan)

    hk.halo_cuda = counting
    try:
        case.state = case.core.step_dynamics(case.state)
    finally:
        hk.halo_cuda = orig
    total = sum(counts.values())
    log(f"[halo] launches in one C{n} npz={npz} dycore step: {total}, by plan and input shapes:")
    for (name, shapes), c in counts.most_common(6):
        log(f"[halo]   {c:5d} {name} {shapes}")
    (name, shapes), c = counts.most_common(1)[0]
    plan, arrays = first[(name, shapes)]
    names = sorted(arrays)
    S, K = arrays[names[0]].shape[:2]
    planes = {k: tuple(v.shape[-2:]) for k, v in arrays.items()}
    ms = time_ms(lambda: hk.halo_cuda(arrays, plan), 20)
    plain_ms = time_ms(lambda: hk.halo_plain(arrays, plan), 5)
    # one torch.take per output over [in0, in1, -in0, -in1] laid end to end
    flat = [arrays[k].reshape(-1) for k in names]
    src = torch.cat(flat + [-f for f in flat])
    start = [0]
    for f in flat[:-1]:
        start.append(start[-1] + f.numel())
    neg_start = sum(f.numel() for f in flat)
    ref = hk.halo_plain(arrays, plan)
    take_idx, out_bytes, map_bytes = [], 0, 0
    for oname, _src, _shape in plan.outputs:
        off, meta = (torch.from_numpy(m).to(dev, torch.int64)
                     for m in hk.index_map(plan, oname, planes, S))
        which = (meta >> 1) & 1
        Pin = torch.tensor([planes[k][0] * planes[k][1] for k in names], device=dev)[which]
        base = torch.tensor(start, device=dev)[which] + (meta & 1) * neg_start
        g = base + (meta >> 2) * (K * Pin) + off  # (S, Yo, Xo), level 0
        lev = torch.arange(K, device=dev).view(1, K, 1, 1) * Pin[:, None]
        idx = (g[:, None] + lev).contiguous()
        if not torch.equal(torch.take(src, idx), ref[oname]):
            raise AssertionError(f"torch.take yardstick disagrees on halo output {oname}")
        take_idx.append(idx)
        out_bytes += nbytes(ref[oname])
        map_bytes += 8 * idx[:, 0].numel()
    lib_ms = time_ms(lambda: [torch.take(src, i) for i in take_idx], 20)
    b_ms, b_by = chip_smoke.bound(2 * out_bytes + map_bytes, 0, torch.float32)
    n_out = len(plan.outputs)
    log(f"[halo] most launched: {name} on {shapes}, {c} launches a step ({n_out} a call): "
        f"kernel {ms:.4f} ms a call, {ms / n_out:.4f} ms a launch, bound {b_ms:.4f} ms a call "
        f"({b_by}), {b_ms / ms:.2f} of it; torch.take {lib_ms:.4f} ms a call; plain "
        f"{plain_ms:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prev", required=True,
                    help="directory of the earlier sources (remap.cu, pgrad.cu, sim1.cu, "
                         "fvtp2d.cu, d_sw_tail.cu, c_sw_tail.cu, d2a2c.cu, hydro.cu, "
                         "updatedz.cu)")
    ap.add_argument("--kernels", default=",".join(KERNELS + ("halo",)),
                    help="comma-separated: remap, pgrad, sim1, fvtp2d, tracer, single, "
                         "d_sw_tail, c_sw_tail, d2a2c, hydro, updatedz_c, halo (default all)")
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--npz", type=int, default=79)
    args = ap.parse_args()
    picked = [k.strip() for k in args.kernels.split(",") if k.strip()]
    unknown = sorted(set(picked) - set(KERNELS + ("halo",)))
    if unknown:
        ap.error(f"unknown kernels {unknown}")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    libs = build_both(args.prev, sorted({LIBRARY.get(k, k) for k in KERNELS if k in picked}))
    ok = True
    if "tracer" in picked:
        ok &= tracer_block(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "single" in picked:
        ok &= single_transport(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "d_sw_tail" in picked:
        ok &= d_sw_tail(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "c_sw_tail" in picked:
        ok &= c_sw_tail(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "d2a2c" in picked:
        ok &= d2a2c(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "hydro" in picked:
        ok &= hydro(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    if "updatedz_c" in picked:
        ok &= updatedz_c(libs, args.n, args.npz, dev)
        torch.cuda.empty_cache()
    libs = {k: v for k, v in libs.items() if k in picked}
    ok &= sim1_and_multi(libs, args.n, args.npz, dev)
    torch.cuda.empty_cache()
    ok &= remap_and_pgrad(libs, args.n, args.npz, dev)
    torch.cuda.empty_cache()
    if "halo" in picked:
        halo_census(args.n, args.npz, dev)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
