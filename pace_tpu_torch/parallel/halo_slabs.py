"""Halo exchange compiled into rigid rotated-slab region ops.

Port of the single-device, stacked-shard part of
``pace_tpu.parallel.halo_slabs``. Every ghost region of every shard is a
rigidly rotated rectangle of exactly one source shard, so an update is, per
region:

    src   = q[perm]                      # leading-axis permutation
    slab  = select_by_class( rot90(src[.., src_rect], k) , ... )
    q[.., dst_rect] = slab

All slab geometry (permutation, rotation, source rectangle, vector component
mapping and signs) is DERIVED at build time from the pointwise resolution of
:mod:`pace_tpu_torch.parallel.halo` and asserted to reproduce it exactly.
Each public method packs its region ops into an
:class:`~pace_tpu_torch.parallel.halo_kernel.ExchangePlan`, which
:func:`~pace_tpu_torch.parallel.halo_kernel.exchange` applies: one gather
kernel pass on the card, the ``_assemble_dus`` strip updates on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .halo import _STAGGER_OFFSETS, _VECTOR_KINDS, HaloExchanger
from ..utils.ranges import stage_range
from .halo_kernel import ExchangePlan
from .halo_kernel import exchange as _exchange

_CORNER_NAMES = ("SW", "SE", "NW", "NE")


def exchange(inputs, plan: ExchangePlan):
    """One exchange inside the "HaloExchange" stage range, which the driver's
    stage profile reads (``collect_communication``)."""
    with stage_range("HaloExchange"):
        return _exchange(inputs, plan)


@dataclasses.dataclass(frozen=True)
class _Class:
    rot_k: int  # rot90 count applied to the source rect
    src_rect: Tuple[int, int, int, int]  # (r0, r1, c0, c1) in source array
    src_comp: str  # "u"/"v" for vectors, "q" for scalars
    sign: float


class _SplitNeeded(Exception):
    """A ghost region is not one rigid single-source copy for every shard
    (it straddles an internal sub-shard boundary on the source side, or its
    rotation varies) — the builder splits it and retries."""


@dataclasses.dataclass(frozen=True)
class _RegionOp:
    dst_rect: Tuple[int, int, int, int]
    perm: np.ndarray  # (S,) source shard per destination shard
    klass_of_shard: np.ndarray  # (S,) index into classes
    classes: Tuple[_Class, ...]
    name: str = ""  # ghost-region name (W/E/S/N/SW/SE/NW/NE)


def _fit_transform(jj, ii, sj, si):
    """Fit src = R @ dst + b over a rectangle of destination indices; returns
    (rot_k, src_rect) such that rot90(src[src_rect], rot_k) aligns with the
    destination rectangle, verified exactly."""
    r0, r1 = int(sj.min()), int(sj.max()) + 1
    c0, c1 = int(si.min()), int(si.max()) + 1
    dst_shape = jj.shape
    for k in range(4):
        # index grid of the source rect, rotated like the data would be
        grid_j, grid_i = np.meshgrid(
            np.arange(r0, r1), np.arange(c0, c1), indexing="ij"
        )
        gj = np.rot90(grid_j, k)
        gi = np.rot90(grid_i, k)
        if gj.shape != dst_shape:
            continue
        if np.array_equal(gj, sj) and np.array_equal(gi, si):
            return k, (r0, r1, c0, c1)
    raise AssertionError("ghost region is not a rigid rotated rectangle")


class HaloUpdateHandle:
    """A started exchange; ``wait()`` completes it (once) and returns its
    result."""

    def __init__(self, finish):
        self._finish = finish
        self._result = None

    def wait(self):
        if self._finish is not None:
            self._result = self._finish()
            self._finish = None
        return self._result


class SlabHalo:
    """Slab-compiled halo exchange bound to one HaloExchanger decomposition."""

    def __init__(self, halo: HaloExchanger):
        self.halo = halo
        self._scalar_ops: Dict = {}
        self._vector_ops: Dict = {}
        self._sync_ops: Dict = {}
        self._plans: Dict = {}

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------
    def _ghost_regions(self, stagger: str):
        from .halo import interface_extents

        h = self.halo.n_halo
        ey, ex = interface_extents(stagger)
        ny = self.halo.nsy + ey
        nx = self.halo.nsx + ex
        yt = ny + 2 * h
        xt = nx + 2 * h
        return {
            "W": ((h, h + ny), (0, h)),
            "E": ((h, h + ny), (h + nx, xt)),
            "S": ((0, h), (h, h + nx)),
            "N": ((h + ny, yt), (h, h + nx)),
            "SW": ((0, h), (0, h)),
            "SE": ((0, h), (h + nx, xt)),
            "NW": ((h + ny, yt), (0, h)),
            "NE": ((h + ny, yt), (h + nx, xt)),
        }

    def _resolve_region(self, stagger: str, fold: str, rect, s: int):
        """Pointwise resolution of one region of one shard (oracle data)."""
        halo = self.halo
        h = halo.n_halo
        oy, ox = _STAGGER_OFFSETS[stagger]
        (r0, r1), (c0, c1) = rect
        jj, ii = np.meshgrid(np.arange(r0, r1), np.arange(c0, c1), indexing="ij")
        t, py, px = halo._shard_info(s)
        gy = py * halo.nsy + (jj - h) + oy
        gx = px * halo.nsx + (ii - h) + ox
        t2, gy2, gx2, A, valid = halo.topology.resolve_points(
            np.full(jj.shape, t), gy, gx, halo.n_tile, corner_fold=fold
        )
        assert valid.all()
        s2, sj, si, fy, fx = halo._locate_source(t2, gy2, gx2)
        if not (s2 == s2.flat[0]).all():
            # Mixed source shards. For interface staggers whose points lie
            # exactly ON an internal sub-shard boundary, the copies are shared
            # (sync/exchange invariant) and the region can be re-homed into
            # the majority shard. Otherwise the region genuinely straddles
            # source shards and must be SPLIT into smaller rigid copies.
            if stagger == "center" or not (t2 == t2.flat[0]).all():
                raise _SplitNeeded(rect)
            vals, counts = np.unique(s2, return_counts=True)
            s_major = int(vals[np.argmax(counts)])
            _t, py, px = halo._shard_info(s_major)
            jl = np.floor(gy2).astype(np.int64) - py * halo.nsy
            il = np.floor(gx2).astype(np.int64) - px * halo.nsx
            sj = jl + halo.n_halo
            si = il + halo.n_halo
            ny, nx = (
                halo.nsy + 2 * halo.n_halo + 1,
                halo.nsx + 2 * halo.n_halo + 1,
            )
            ok = (
                (sj >= 0).all() and (sj < ny).all()
                and (si >= 0).all() and (si < nx).all()
                and (jl >= 0).all() and (jl <= halo.nsy).all()
                and (il >= 0).all() and (il <= halo.nsx).all()
            )
            if not ok:
                raise _SplitNeeded(rect)
            s2 = np.full_like(s2, s_major)
        return jj, ii, int(s2.flat[0]), sj, si, A

    # ------------------------------------------------------------------
    # op construction
    # ------------------------------------------------------------------
    def _region_ops_split(self, name, rect, build_one) -> List[_RegionOp]:
        """Build the op for ``rect``; on _SplitNeeded bisect (rows first,
        then columns) and recurse — straddling regions become a few smaller
        rigid copies (they are at most halo-width sized, so this stays tiny)."""
        try:
            return [build_one(name, rect)]
        except (_SplitNeeded, AssertionError):
            (r0, r1), (c0, c1) = rect
            if r1 - r0 > 1:
                mid = (r0 + r1) // 2
                halves = [((r0, mid), (c0, c1)), ((mid, r1), (c0, c1))]
            elif c1 - c0 > 1:
                mid = (c0 + c1) // 2
                halves = [((r0, r1), (c0, mid)), ((r0, r1), (mid, c1))]
            else:
                raise
            out = []
            for h in halves:
                out.extend(self._region_ops_split(name, h, build_one))
            return out

    def _build_scalar_ops(self, stagger: str, fold: str) -> List[_RegionOp]:
        halo = self.halo

        def build_one(name, rect):
            perm = np.zeros(halo.n_shards, dtype=np.int32)
            klass = np.zeros(halo.n_shards, dtype=np.int32)
            classes: List[_Class] = []
            for s in range(halo.n_shards):
                jj, ii, s2, sj, si, _A = self._resolve_region(
                    stagger, fold, rect, s
                )
                rot_k, src_rect = _fit_transform(jj, ii, sj, si)
                c = _Class(rot_k, src_rect, "q", 1.0)
                if c not in classes:
                    classes.append(c)
                perm[s] = s2
                klass[s] = classes.index(c)
            (r0, r1), (c0, c1) = rect
            return _RegionOp((r0, r1, c0, c1), perm, klass, tuple(classes), name)

        ops = []
        for name, rect in self._ghost_regions(stagger).items():
            ops.extend(self._region_ops_split(name, rect, build_one))
        return ops

    def _build_vector_ops(self, kind: str, fold: str):
        """Ops for (u, v): per destination component a list of region ops whose
        classes carry the source component and sign."""
        halo = self.halo
        loc_u, dir_u, loc_v, dir_v = _VECTOR_KINDS[kind]
        out = {}
        for comp, (loc, direction) in (("u", (loc_u, dir_u)), ("v", (loc_v, dir_v))):
            d = np.asarray(direction)

            def build_one(name, rect):
                perm = np.zeros(halo.n_shards, dtype=np.int32)
                klass = np.zeros(halo.n_shards, dtype=np.int32)
                classes: List[_Class] = []
                for s in range(halo.n_shards):
                    jj, ii, s2, sj, si, A = self._resolve_region(loc, fold, rect, s)
                    a0 = A.reshape(-1, 2, 2)[0]
                    if not np.allclose(A, a0):
                        raise _SplitNeeded(rect)  # rotation varies in region
                    img = a0 @ d
                    if abs(img[1]) > 0.5:
                        src_comp, sign = "u", float(np.sign(img[1]))
                    else:
                        src_comp, sign = "v", float(np.sign(img[0]))
                    rot_k, src_rect = _fit_transform(jj, ii, sj, si)
                    c = _Class(rot_k, src_rect, src_comp, sign)
                    if c not in classes:
                        classes.append(c)
                    perm[s] = s2
                    klass[s] = classes.index(c)
                (r0, r1), (c0, c1) = rect
                return _RegionOp((r0, r1, c0, c1), perm, klass, tuple(classes), name)

            ops = []
            for name, rect in self._ghost_regions(loc).items():
                ops.extend(self._region_ops_split(name, rect, build_one))
            out[comp] = ops
        return out

    def _scalar_ops_for(self, stagger: str, fold: str):
        key = (stagger, fold)
        if key not in self._scalar_ops:
            self._scalar_ops[key] = self._build_scalar_ops(stagger, fold)
        return self._scalar_ops[key]

    def _vector_ops_for(self, kind: str, fold: str):
        key = (kind, fold)
        if key not in self._vector_ops:
            self._vector_ops[key] = self._build_vector_ops(kind, fold)
        return self._vector_ops[key]

    # ------------------------------------------------------------------
    # plans: which outputs an exchange writes, from which inputs, by which
    # region ops (cached: the kernel's index maps are cached on the plan)
    # ------------------------------------------------------------------
    def _plan(self, key, build):
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = build()
        return plan

    def scalar_plan(self, stagger: str = "center", fold: str = "x") -> ExchangePlan:
        return self._plan(
            ("scalar", stagger, fold),
            lambda: ExchangePlan(
                outputs=(("q", "q", None),),
                ops=tuple(("q", op) for op in self._scalar_ops_for(stagger, fold)),
            ),
        )

    def vector_plan(self, kind: str = "dgrid", fold: str = "x") -> ExchangePlan:
        def build():
            ops = self._vector_ops_for(kind, fold)
            return ExchangePlan(
                outputs=(("u", "u", None), ("v", "v", None)),
                ops=tuple(("u", op) for op in ops["u"])
                + tuple(("v", op) for op in ops["v"]),
            )

        return self._plan(("vector", kind, fold), build)

    def fold_patch_plan(self, stagger: str = "center") -> ExchangePlan:
        """x-fold output ``qx`` plus the y-fold's corner pack ``qp``."""
        h = self.halo.n_halo
        return self._plan(
            ("fold_patch", stagger),
            lambda: ExchangePlan(
                outputs=(("qx", "q", None), ("qp", None, (2 * h, 2 * h))),
                ops=tuple(("qx", op) for op in self._scalar_ops_for(stagger, "x"))
                + tuple(("qp", op) for op in self._patch_ops(stagger, "y")),
            ),
        )

    def scalar_folds_plan(self, stagger: str = "center") -> ExchangePlan:
        """Both folds of one field: outputs ``qx`` and ``qy``."""
        return self._plan(
            ("scalar_folds", stagger),
            lambda: ExchangePlan(
                outputs=(("qx", "q", None), ("qy", "q", None)),
                ops=tuple(("qx", op) for op in self._scalar_ops_for(stagger, "x"))
                + tuple(("qy", op) for op in self._scalar_ops_for(stagger, "y")),
            ),
        )

    def vector_pair_plan(
        self, kind: str = "dgrid", fold_u: str = "y", fold_v: str = "x"
    ) -> ExchangePlan:
        """``uf`` = u in ``fold_u``, ``vf`` = v in ``fold_v``."""
        return self._plan(
            ("vector_pair", kind, fold_u, fold_v),
            lambda: ExchangePlan(
                outputs=(("uf", "u", None), ("vf", "v", None)),
                ops=tuple(("uf", op) for op in self._vector_ops_for(kind, fold_u)["u"])
                + tuple(("vf", op) for op in self._vector_ops_for(kind, fold_v)["v"]),
            ),
        )

    def sync_plan(self, kind: str = "dgrid") -> ExchangePlan:
        def build():
            if kind not in self._sync_ops:
                self._sync_ops[kind] = self._build_sync_ops(kind)
            ops = self._sync_ops[kind]
            return ExchangePlan(
                outputs=(("u", "u", None), ("v", "v", None)),
                ops=tuple(("u", op) for op in ops["u"])
                + tuple(("v", op) for op in ops["v"]),
            )

        return self._plan(("sync", kind), build)

    # ------------------------------------------------------------------
    # application
    # ------------------------------------------------------------------
    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        return exchange({"q": q}, self.scalar_plan(stagger, fold))["q"]

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        """Several same-shaped scalar fields, one exchange per field (no
        stacking copy)."""
        return [self.update_scalar(q, stagger=stagger, fold=fold) for q in qs]

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        out = exchange({"u": u, "v": v}, self.vector_plan(kind, fold))
        return out["u"], out["v"]

    # the x and y folds differ only in the four corner ghost regions
    def update_scalar_folds(self, q, stagger: str = "center"):
        """(q_xfold, q_yfold) from one exchange that reads ``q`` once."""
        out = exchange({"q": q}, self.scalar_folds_plan(stagger))
        return out["qx"], out["qy"]

    def update_vector_folds(self, u, v, kind: str = "dgrid"):
        """((u_x, v_x), (u_y, v_y)): one exchange per fold."""
        return (
            self.update_vector(u, v, kind=kind, fold="x"),
            self.update_vector(u, v, kind=kind, fold="y"),
        )

    def update_vector_fold_pair(
        self, u, v, kind: str = "dgrid", fold_u: str = "y", fold_v: str = "x"
    ):
        """(u in fold_u, v in fold_v): only the fold each component's
        consumer reads. The D-grid u is y-swept and v x-swept, and c_sw's
        A-grid consumers read va_x/ua_y only, so the other two fold results
        are never written."""
        out = exchange({"u": u, "v": v}, self.vector_pair_plan(kind, fold_u, fold_v))
        return out["uf"], out["vf"]

    def update_scalar_fold_patch(self, q, stagger: str = "center"):
        """(q_xfold, y_corner_patch). The patch is the y-fold's four corner
        ghost regions packed [[SW, SE], [NW, NE]] into (…, 2h, 2h);
        apply_corner_patch(q_xfold, patch) == update_scalar(q, fold="y")."""
        out = exchange({"q": q}, self.fold_patch_plan(stagger))
        return out["qx"], out["qp"]

    def update_scalars_fold_patches(self, qs, stagger: str = "center"):
        """[(qi_xfold, yi_patch)] for several same-shaped fields."""
        return [self.update_scalar_fold_patch(q, stagger=stagger) for q in qs]

    def start_update_scalars_fold_patches(self, qs, stagger: str = "center"):
        """Two-call form of :meth:`update_scalars_fold_patches`: returns a
        handle whose ``wait()`` gives the pairs. With the six tiles on one
        device nothing is in flight between the calls; the handle defers the
        exchange to ``wait()``."""
        qs = list(qs)
        return HaloUpdateHandle(
            lambda: self.update_scalars_fold_patches(qs, stagger=stagger)
        )

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        """Tile-edge interface values of (u, v) set to the edge owner's."""
        out = exchange({"u": u, "v": v}, self.sync_plan(kind))
        return out["u"], out["v"]

    def _patch_ops(self, stagger: str, fold: str):
        """The fold's corner-region ops with dst rects remapped into the
        (2h, 2h) patch plane: low rows/cols keep their offsets, high
        rows/cols shift down by (ny, nx)."""
        from .halo import interface_extents

        h = self.halo.n_halo
        ey, ex = interface_extents(stagger)
        ny = self.halo.nsy + ey
        nx = self.halo.nsx + ex
        ops = []
        for op in self._scalar_ops_for(stagger, fold):
            if op.name not in _CORNER_NAMES:
                continue
            r0, r1, c0, c1 = op.dst_rect
            pr0 = r0 if r0 < h else r0 - ny
            pc0 = c0 if c0 < h else c0 - nx
            ops.append(
                dataclasses.replace(
                    op,
                    dst_rect=(pr0, pr0 + (r1 - r0), pc0, pc0 + (c1 - c0)),
                )
            )
        return ops

    def _build_sync_ops(self, kind: str):
        """One thin-line region op per (component, tile edge). Shards that are
        not at that tile edge — or that OWN the edge — get the identity class
        (a no-op copy of their own line)."""
        from .topology import EDGE_E, EDGE_N, EDGE_S, EDGE_W

        halo = self.halo
        h = halo.n_halo
        n = halo.n_tile
        S = halo.n_shards
        ly, lx = halo.partitioner.layout
        loc_u, dir_u, loc_v, dir_v = _VECTOR_KINDS[kind]
        ops = {"u": [], "v": []}
        for comp, (loc, direction) in (("u", (loc_u, dir_u)), ("v", (loc_v, dir_v))):
            oy, ox = _STAGGER_OFFSETS[loc]
            if ox == 0.0 and oy != 0.0:  # x-interface lines on W/E edges
                edges = [
                    (EDGE_W, (h, h + halo.nsy), (h, h + 1), lambda px: px == 0),
                    (
                        EDGE_E,
                        (h, h + halo.nsy),
                        (h + halo.nsx, h + halo.nsx + 1),
                        lambda px: px == lx - 1,
                    ),
                ]
                border_of = "x"
            elif oy == 0.0 and ox != 0.0:  # y-interface lines on S/N edges
                edges = [
                    (EDGE_S, (h, h + 1), (h, h + halo.nsx), lambda py: py == 0),
                    (
                        EDGE_N,
                        (h + halo.nsy, h + halo.nsy + 1),
                        (h, h + halo.nsx),
                        lambda py: py == ly - 1,
                    ),
                ]
                border_of = "y"
            else:
                continue
            d = np.asarray(direction)
            for e, (r0, r1), (c0, c1), is_border in edges:

                def build_one(name, rect, _e=e, _is_border=is_border,
                              _comp=comp, _oy=oy, _ox=ox, _d=d,
                              _border_of=border_of):
                    (rr0, rr1), (cc0, cc1) = rect
                    flat = (rr0, rr1, cc0, cc1)
                    identity = _Class(0, flat, _comp, 1.0)
                    classes = [identity]
                    perm = np.arange(S, dtype=np.int32)
                    klass = np.zeros(S, dtype=np.int32)
                    for s in range(S):
                        t, py, px = halo._shard_info(s)
                        if not _is_border(px if _border_of == "x" else py):
                            continue
                        rel = halo.topology.adjacency.get((t, _e))
                        if rel is None:
                            continue
                        if (t, _e) <= (rel.neighbor_tile, rel.neighbor_edge):
                            continue  # owner keeps its values
                        A, b = halo.topology.edge_affine(t, _e, n)
                        jj, ii = np.meshgrid(
                            np.arange(rr0, rr1), np.arange(cc0, cc1),
                            indexing="ij",
                        )
                        gy = py * halo.nsy + (jj - h) + _oy
                        gx = px * halo.nsx + (ii - h) + _ox
                        gy2 = A[0, 0] * gy + A[0, 1] * gx + b[0]
                        gx2 = A[1, 0] * gy + A[1, 1] * gx + b[1]
                        t2 = np.full(jj.shape, rel.neighbor_tile)
                        s2, sj, si, _fy, _fx = halo._locate_source(t2, gy2, gx2)
                        if not (s2 == s2.flat[0]).all():
                            # rotated neighbor edge subdivided differently
                            # (non-square layout) — bisect and retry
                            raise _SplitNeeded(rect)
                        rot_k, src_rect = _fit_transform(jj, ii, sj, si)
                        img = A @ _d
                        if abs(img[1]) > 0.5:
                            src_comp, sign = "u", float(np.sign(img[1]))
                        else:
                            src_comp, sign = "v", float(np.sign(img[0]))
                        c = _Class(rot_k, src_rect, src_comp, sign)
                        if c not in classes:
                            classes.append(c)
                        perm[s] = int(s2.flat[0])
                        klass[s] = classes.index(c)
                    return _RegionOp(
                        flat, perm, klass, tuple(classes), name=name
                    )

                ops[comp].extend(
                    self._region_ops_split(
                        f"sync-{comp}", ((r0, r1), (c0, c1)), build_one
                    )
                )
        return ops
