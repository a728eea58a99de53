"""The work model: the least time the H100 could take for the work of one
dycore step, operator by operator.

A frozen copy of the counting in the program's ``chip_smoke.py`` (its
``*_OPS_PER_POINT`` constants and the operands its ``bound`` lines count),
written as formulas of the step's shapes so that it holds at any resolution:

- each of the 14 FV3 operators that have a hand-written kernel has its
  bytes (each input read once, each output written once) and its
  floating-point operations for one call, from the shapes of its operands;
- its bound is the larger of bytes over the peak bandwidth and operations
  over the peak rate (:mod:`.peaks`);
- the calls per step come from the configuration (``k_split``,
  ``n_split``, hydrostatic or not) and from the tracer sub-cycles the step
  took (``DynamicalCore.tracer_subcycles``), never from launches, so the
  bound counts the same work whatever kernel, fusion or graph implements it.

The plain PyTorch glue between the operators counts as no work.

Shapes: ``S`` shards, ``K`` layers, ``nq`` tracers, ``P`` the points of a
shard's cell-centre plane along each axis (tile cells plus both halos),
``h`` the halo width. Planes: centre ``P x P``, x-interfaces ``P x (P+1)``,
y-interfaces ``(P+1) x P``, corners ``(P+1) x (P+1)``, the corner pack
``2h x 2h``, and the edge lines ``1 x (P+1)`` of the grid's edge masks.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Tuple

from .peaks import PEAK_BYTES_PER_S, peak_ops_per_s

# Floating-point operations per output point (chip_smoke.py's constants,
# whose comments derive each count).
#: fvtp2d by hord: four 1-D PPM evaluations, two inner updates, two results
FVTP2D_OPS_PER_POINT = {6: 4 * 14 + 20, 8: 4 * 34 + 20}
D2A2C_OPS_PER_POINT = 95
C_SW_TAIL_OPS_PER_POINT = 98
HYDRO_OPS_PER_POINT = 13
HEIGHTS_OPS_PER_POINT = 2
UPDATEDZ_C_OPS_PER_POINT = 26
SIM1_OPS_PER_POINT = 61
#: the D-grid tail at nord 3 with every switch on; each order of the
#: damping below 3 saves one Laplacian of 9 operations
D_SW_TAIL_OPS_PER_POINT = 96
D_SW_TAIL_OPS_PER_LAPLACIAN = 9
FLUX_HEIGHT_OPS_PER_POINT = 10
PGRAD_OPS_PER_POINT = 90
REMAP_OPS_PER_POINT = 92

#: operator -> the names of its CUDA kernels as the profiler's trace shows
#: them (``void <name><float>(...)``)
KERNELS = {
    "halo": ("halo_gather",),
    "fvtp2d": ("fvtp2d_single_kernel",),
    "fvtp2d_multi": ("fvtp2d_multi_kernel",),
    "fvtp2d_tracer": ("fvtp2d_tracer_kernel",),
    "d2a2c": ("d2a2c_kernel",),
    "c_sw_tail": ("c_sw_tail_kernel", "c_sw_corner_kernel"),
    "hydro": ("hydro_kernel", "hydro_gz_kernel"),
    "heights": ("heights_kernel",),
    "updatedz_c": ("updatedz_c_kernel",),
    "flux_height_update": ("flux_height_update_kernel",),
    "sim1": ("sim1_kernel",),
    "pgrad": ("pgrad_kernel",),
    "d_sw_tail": ("d_sw_tail_kernel",),
    "remap": ("remap_kernel",),
}


def _hord_ops(hord: int) -> int:
    """fvtp2d's operations per point at ``hord`` (5 counts as 6, 7 as 8)."""
    return FVTP2D_OPS_PER_POINT[6 if hord in (5, 6) else 8]


@dataclasses.dataclass(frozen=True)
class Shapes:
    S: int
    K: int
    nq: int
    P: int
    h: int = 3
    itemsize: int = 4

    @classmethod
    def of_state(cls, delp_shape: Tuple[int, ...], nq: int, n_halo: int, itemsize: int):
        """From the state's ``delp`` shape ``(S, K, P, P)``."""
        S, K, Y, X = delp_shape
        if Y != X:
            raise ValueError(f"the work model takes square shard planes, got {Y} x {X}")
        return cls(S, K, nq, Y, n_halo, itemsize)

    # plane sizes in points, over all shards
    @property
    def c(self):
        return self.S * self.P * self.P

    @property
    def xi(self):
        return self.S * self.P * (self.P + 1)

    yi = xi

    @property
    def co(self):
        return self.S * (self.P + 1) ** 2

    @property
    def pack(self):
        return self.S * (2 * self.h) ** 2

    @property
    def line(self):
        return self.S * (self.P + 1)


# ----------------------------------------------------------------------
# One call of each operator form: (bytes, operations).
# ----------------------------------------------------------------------
def halo_bytes(s: Shapes, levels: int, plane: str) -> int:
    """One launch of the halo kernel, one output plane: a whole-plane output
    reads its source and writes itself (twice the output); the corner pack
    is written from a source its sibling output already read (once); every
    point goes through an 8-byte index map."""
    pts = {"c": s.c, "xi": s.xi, "yi": s.yi, "co": s.co, "pack": s.pack}[plane]
    out = levels * pts * s.itemsize
    return (out if plane == "pack" else 2 * out) + 8 * pts


def fvtp2d_single(s: Shapes, levels: int, hord: int, corner_pack: bool) -> Tuple[int, int]:
    """The single-field transport: q in both folds (the y fold as the corner
    pack or a full plane), Courant numbers and area fluxes (x, y), the area,
    and the two fluxes written."""
    K = levels
    qy = K * s.pack if corner_pack else K * s.c
    pts = K * s.c + qy + 3 * K * s.xi + 3 * K * s.yi + s.c
    return pts * s.itemsize, _hord_ops(hord) * K * s.c


def fvtp2d_multi(s: Shapes, hords: Iterable[int], packs: Iterable[bool]) -> Tuple[int, int]:
    """The multi-field transport of d_sw: each field in both folds (the y
    fold as the corner pack where ``packs`` says so), the shared Courant
    numbers, area fluxes, area and mass fluxes, and two
    fluxes written per field."""
    hords, packs = list(hords), list(packs)
    K = s.K
    fields = sum(K * s.c + (K * s.pack if p else K * s.c) for p in packs)
    pts = fields + 2 * K * s.xi + 2 * K * s.yi + s.c + K * s.xi + K * s.yi
    pts += len(hords) * K * (s.xi + s.yi)
    ops = (sum(_hord_ops(h) for h in hords) + 4) * K * s.c
    return pts * s.itemsize, ops


def fvtp2d_tracer(s: Shapes, hord: int) -> Tuple[int, int]:
    """The tracer block: nq tracers in both folds (x fold and corner pack),
    the shared Courant numbers, area and mass fluxes, and each tracer's two
    fluxes written."""
    K, nq = s.K, s.nq
    pts = nq * K * (s.c + s.pack) + 3 * K * (s.xi + s.yi) + s.c + nq * K * (s.xi + s.yi)
    return pts * s.itemsize, _hord_ops(hord) * nq * K * s.c


def d2a2c(s: Shapes) -> Tuple[int, int]:
    """D-grid winds in, 14 metric arrays (three of them 3-vectors and one a
    3 x 3 matrix), ua, va, uc, vc, ut, vt out."""
    K = s.K
    pts = K * (s.xi + s.yi) + 18 * s.c + 8 * s.xi + 8 * s.yi + K * (2 * s.c + 2 * s.xi + 2 * s.yi)
    return pts * s.itemsize, D2A2C_OPS_PER_POINT * K * s.c


def c_sw_tail(s: Shapes) -> Tuple[int, int]:
    """14 fields in (winds and their folds, delp, pt, the A-grid winds), 19
    metric arrays and the 4 divergence edge weights, 9 outputs."""
    K = s.K
    fields_in = K * (6 * s.c + 4 * s.xi + 4 * s.yi)
    consts = 5 * s.c + 7 * s.xi + 7 * s.yi + 2 * s.co + 2 * s.line
    out = K * (2 * s.c + 3 * s.xi + 3 * s.yi + s.co)
    return (fields_in + consts + out) * s.itemsize, C_SW_TAIL_OPS_PER_POINT * K * s.c


def hydro(s: Shapes, need: Tuple[str, ...]) -> Tuple[int, int]:
    """The hydrostatic column chain: delp (and pt, phis when gz is asked
    for) in, the asked-for outputs (pk and gz at interfaces, pkz in
    layers) out."""
    K = s.K
    reads = K * s.c + ((K * s.c + s.c) if "gz" in need else 0)
    outs = sum({"pk": (K + 1), "pkz": K, "gz": (K + 1), "pe": (K + 1), "peln": (K + 1)}[n]
               for n in need) * s.c
    return (reads + outs) * s.itemsize, HYDRO_OPS_PER_POINT * K * s.c


def heights(s: Shapes) -> Tuple[int, int]:
    """delz and the surface height in, the interface heights out."""
    K = s.K
    return (K * s.c + s.c + (K + 1) * s.c) * s.itemsize, HEIGHTS_OPS_PER_POINT * K * s.c


def updatedz_c(s: Shapes) -> Tuple[int, int]:
    """Heights in both folds, area fluxes and area in; heights and ws out."""
    K = s.K
    pts = 3 * (K + 1) * s.c + K * (s.xi + s.yi) + 2 * s.c
    return pts * s.itemsize, UPDATEDZ_C_OPS_PER_POINT * (K + 1) * s.c


def flux_height_update(s: Shapes) -> Tuple[int, int]:
    """Heights, their fluxes and the interface area fluxes in, heights out."""
    K1 = s.K + 1
    return (K1 * (2 * s.c + 2 * s.xi + 2 * s.yi) + s.c) * s.itemsize, \
        FLUX_HEIGHT_OPS_PER_POINT * K1 * s.c


def sim1(s: Shapes) -> Tuple[int, int]:
    """w, delz, pt, delp, pkz and ws in; w, delz and pp out."""
    K = s.K
    return ((8 * K + 2) * s.c) * s.itemsize, SIM1_OPS_PER_POINT * K * s.c


def pgrad(s: Shapes) -> Tuple[int, int]:
    """u, v, pk, gz, pp, delp and 14 metric arrays in; u and v out."""
    K = s.K
    pts = K * (2 * s.xi + 2 * s.yi) + (3 * K + 3) * s.c + K * s.c + 4 * s.xi + 4 * s.yi \
        + 6 * s.line
    return pts * s.itemsize, PGRAD_OPS_PER_POINT * K * s.c


def d_sw_tail(s: Shapes, nord: int) -> Tuple[int, int]:
    """10 fields in (winds, advective winds, divergence, vorticity and its
    fluxes), 13 metric arrays and 4 edge masks; u, v and the heating out."""
    K = s.K
    pts = K * (5 * s.xi + 5 * s.yi + s.co + 2 * s.c) + 3 * s.xi + 3 * s.yi + 3 * s.c + s.co \
        + 4 * s.line
    ops = D_SW_TAIL_OPS_PER_POINT - D_SW_TAIL_OPS_PER_LAPLACIAN * max(0, 3 - nord)
    return pts * s.itemsize, ops * K * s.c


def remap(s: Shapes, plane: str, fields: int = 1) -> Tuple[int, int]:
    """One remapped block of ``fields`` fields on ``plane``: the block read
    and written, the source and target interface pressures read once."""
    K = s.K
    pts = {"c": s.c, "xi": s.xi, "yi": s.yi}[plane]
    return (2 * fields * K * pts + 2 * (K + 1) * pts) * s.itemsize, \
        REMAP_OPS_PER_POINT * fields * K * pts


# ----------------------------------------------------------------------
# Calls per step
# ----------------------------------------------------------------------
#: halo launches by phase: (levels class, plane) -> launches; levels classes
#: "K", "K+1", "nq*K" and "1" (counted on the program's step at C12 with
#: every exchange recorded by where it was made)
HALO_NONHYDROSTATIC = {
    "substep": {("K", "pack"): 4, ("K", "c"): 12, ("K", "xi"): 14, ("K", "yi"): 14,
                ("K", "co"): 1, ("K+1", "c"): 1},
    "outer": {("1", "c"): 2},
    "subcycle": {("nq*K", "pack"): 1, ("nq*K", "c"): 1, ("nq*K", "xi"): 1, ("nq*K", "yi"): 1},
    "step": {("K", "xi"): 1, ("K", "yi"): 1},
}
HALO_HYDROSTATIC = dict(HALO_NONHYDROSTATIC, substep={
    ("K", "pack"): 3, ("K", "c"): 7, ("K", "xi"): 12, ("K", "yi"): 12, ("K", "co"): 1})


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What of the dycore configuration the work depends on."""

    k_split: int
    n_split: int
    hydrostatic: bool = False
    nord: int = 3
    hord_dp: int = 6
    hord_tm: int = 6
    hord_vt: int = 6
    hord_tr: int = 8

    @classmethod
    def of(cls, cfg) -> "StepConfig":
        """From a dycore config object with these attributes."""
        return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


def calls(cfg: StepConfig, s: Shapes, subcycles: Iterable[int]
          ) -> Dict[str, List[Tuple[int, Tuple[int, int]]]]:
    """operator -> [(calls in the step, (bytes, operations) of one call)]
    for one step whose outer steps took ``subcycles`` tracer sub-cycles."""
    n_sub = cfg.k_split * cfg.n_split
    n_outer = cfg.k_split
    n_tracer = sum(subcycles)
    out: Dict[str, List] = collections.defaultdict(list)
    levels = {"K": s.K, "K+1": s.K + 1, "nq*K": s.nq * s.K, "1": 1}
    inventory = HALO_HYDROSTATIC if cfg.hydrostatic else HALO_NONHYDROSTATIC
    times = {"substep": n_sub, "outer": n_outer, "subcycle": n_tracer, "step": 1}
    for phase, launches in inventory.items():
        for (lev, plane), n in launches.items():
            out["halo"].append((n * times[phase], (halo_bytes(s, levels[lev], plane), 0)))
    out["d2a2c"].append((n_sub + 1, d2a2c(s)))
    out["c_sw_tail"].append((n_sub, c_sw_tail(s)))
    out["d_sw_tail"].append((n_sub, d_sw_tail(s, cfg.nord)))
    out["fvtp2d_tracer"].append((n_tracer, fvtp2d_tracer(s, cfg.hord_tr)))
    if cfg.hydrostatic:
        out["hydro"] += [(n_sub, hydro(s, ("pk", "pkz", "gz"))), (n_sub, hydro(s, ("pk", "gz")))]
        out["fvtp2d"].append((n_sub, fvtp2d_single(s, s.K, cfg.hord_dp, True)))
        out["fvtp2d_multi"].append((n_sub, fvtp2d_multi(s, (cfg.hord_tm, cfg.hord_vt),
                                                        (True, True))))
        remapped = [("c", 1)]  # pt
    else:
        out["hydro"] += [(n_sub, hydro(s, ("pkz",))), (n_sub, hydro(s, ("pk", "pkz")))]
        out["fvtp2d"] += [(n_sub, fvtp2d_single(s, s.K, cfg.hord_dp, True)),
                          (n_sub, fvtp2d_single(s, s.K + 1, 5, False))]
        out["fvtp2d_multi"].append((n_sub, fvtp2d_multi(
            s, (cfg.hord_tm, cfg.hord_vt, cfg.hord_vt), (True, True, True))))
        out["heights"].append((4 * n_sub, heights(s)))
        out["updatedz_c"].append((n_sub, updatedz_c(s)))
        out["sim1"].append((2 * n_sub, sim1(s)))
        out["flux_height_update"].append((n_sub, flux_height_update(s)))
        out["pgrad"].append((n_sub, pgrad(s)))
        remapped = [("c", 1), ("c", 1), ("c", 1)]  # pt, w, delz / dp1
    for plane, f in remapped + [("yi", 1), ("xi", 1)]:  # ..., u, v
        out["remap"].append((n_outer, remap(s, plane, f)))
    out["remap"].append((n_outer, remap(s, "c", s.nq)))  # the tracer block
    return dict(out)


def bound_seconds(moved_bytes: float, ops: float, itemsize: int = 4) -> float:
    """The least time for ``moved_bytes`` and ``ops`` at the card's peaks."""
    return max(moved_bytes / PEAK_BYTES_PER_S, ops / peak_ops_per_s(itemsize))


def step_bound(cfg: StepConfig, s: Shapes, subcycles: Iterable[int]) -> Dict[str, float]:
    """operator -> seconds of its bound over one step."""
    return {op: sum(n * bound_seconds(b, o, s.itemsize) for n, (b, o) in forms)
            for op, forms in calls(cfg, s, subcycles).items()}


def launches(cfg: StepConfig, s: Shapes, subcycles: Iterable[int]) -> Dict[str, int]:
    """operator -> calls in one step (one halo call is one launch)."""
    return {op: sum(n for n, _ in forms) for op, forms in calls(cfg, s, subcycles).items()}
