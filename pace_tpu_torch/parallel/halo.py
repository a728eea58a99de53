"""Halo exchange geometry: region tables for stacked shard tensors.

Port of ``pace_tpu.parallel.halo`` (reference role: ``ndsl.comm.communicator``
+ ``HaloUpdater``, halo_update / vector halo update with tile-edge rotation).

- Model state is carried as stacked per-shard tensors ``(S, ..., Y, X)`` where
  ``S = 6 * layout_y * layout_x`` and the last two axes are the shard's local
  domain *including* ``n_halo`` ghost cells per side.
- At init, host-side numpy tables map every ghost cell to its true source
  cell (shard, j, i) — including cross-tile rotation, vector component swaps
  and sign flips, and geometric corner fills (see
  :mod:`pace_tpu_torch.parallel.topology`). They are the oracle from which
  :mod:`pace_tpu_torch.parallel.halo_slabs` derives its region ops.
- An update is applied by :mod:`pace_tpu_torch.parallel.halo_kernel`: one
  gather pass on the card, strip updates on the CPU.

Corner-fold semantics: ``fold="x"`` fills corner halo regions with data
consistent with x-direction sweeps (the reference's ``copy_corners`` x-variant
analog), ``fold="y"`` the transpose. The fills are exact field values at the
folded ghost locations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .. import constants
from .partitioner import CubedSpherePartitioner
from .topology import Topology

# (y_offset, x_offset) of the grid-point location within a cell, and whether the
# owned index range along each axis is interface-inclusive.
_STAGGER_OFFSETS: Dict[str, Tuple[float, float]] = {
    "center": (0.5, 0.5),
    "corner": (0.0, 0.0),
    "y_interface": (0.0, 0.5),  # D-grid u location
    "x_interface": (0.5, 0.0),  # D-grid v location
}


def interface_extents(stagger: str) -> Tuple[int, int]:
    """(ey, ex): extra owned points along y/x — 1 on interface-inclusive
    axes (offset 0.0), 0 on cell-centered axes. The single source of the
    extent rule shared by the halo layout and gather/scatter."""
    oy, ox = _STAGGER_OFFSETS[stagger]
    return (1 if oy == 0.0 else 0), (1 if ox == 0.0 else 0)

# (u_location, u_direction, v_location, v_direction); directions in (dy, dx).
_VECTOR_KINDS = {
    # D-grid: u = x-direction wind at y-interfaces, v = y-direction at x-interfaces
    "dgrid": ("y_interface", (0.0, 1.0), "x_interface", (1.0, 0.0)),
    # C-grid: uc = x-direction wind at x-interfaces, vc = y-direction at y-interfaces
    "cgrid": ("x_interface", (0.0, 1.0), "y_interface", (1.0, 0.0)),
    # A-grid: both components at cell centers
    "agrid": ("center", (0.0, 1.0), "center", (1.0, 0.0)),
}


@dataclasses.dataclass(frozen=True)
class _SubTable:
    """Gather/scatter index set: dst[comp][ds, dj, di] = sign * src[ss, sj, si]
    (host-side numpy)."""

    ds: np.ndarray
    dj: np.ndarray
    di: np.ndarray
    ss: np.ndarray
    sj: np.ndarray
    si: np.ndarray
    sign: np.ndarray

    @property
    def size(self) -> int:
        return int(self.ds.shape[0])


def _as_subtable(rows: np.ndarray) -> _SubTable:
    rows = np.asarray(rows)
    if rows.size == 0:
        rows = np.zeros((0, 7))
    idx = rows[:, :6].astype(np.int32)
    return _SubTable(
        ds=idx[:, 0],
        dj=idx[:, 1],
        di=idx[:, 2],
        ss=idx[:, 3],
        sj=idx[:, 4],
        si=idx[:, 5],
        sign=rows[:, 6].astype(np.float32),
    )


class HaloExchanger:
    """Halo geometry of one decomposition; applies updates through its
    :class:`~pace_tpu_torch.parallel.halo_slabs.SlabHalo`.

    Parameters
    ----------
    topology:
        tile connectivity (cubed sphere or doubly periodic).
    partitioner:
        shard layout (6 tiles × layout for the sphere; use a partitioner whose
        ``N_TILES`` worth of tiles equals ``topology.n_tiles``).
    n_tile:
        tile extent in cells (e.g. 192 for C192).
    n_halo:
        ghost depth (reference N_HALO_DEFAULT=3).
    """

    def __init__(
        self,
        topology: Topology,
        partitioner: CubedSpherePartitioner,
        n_tile: int,
        n_halo: int = constants.N_HALO_DEFAULT,
    ):
        self.topology = topology
        self.partitioner = partitioner
        self.n_tile = int(n_tile)
        self.n_halo = int(n_halo)
        ly, lx = partitioner.layout
        if self.n_tile % ly or self.n_tile % lx:
            raise ValueError(f"n_tile={n_tile} not divisible by layout {(ly, lx)}")
        self.nsy = self.n_tile // ly
        self.nsx = self.n_tile // lx
        if min(self.nsy, self.nsx) < self.n_halo:
            raise ValueError(
                f"shard extent ({self.nsy},{self.nsx}) smaller than halo {n_halo}"
            )
        self.n_shards = topology.n_tiles * ly * lx
        self._scalar_tables: Dict = {}
        self._vector_tables: Dict = {}
        self._sync_tables: Dict = {}

    # ------------------------------------------------------------------
    # shapes
    # ------------------------------------------------------------------
    def shard_shape(self, stagger: str = "center") -> Tuple[int, int]:
        oy, ox = _STAGGER_OFFSETS[stagger]
        ey = 1 if oy == 0.0 else 0
        ex = 1 if ox == 0.0 else 0
        return (
            self.nsy + ey + 2 * self.n_halo,
            self.nsx + ex + 2 * self.n_halo,
        )

    # ------------------------------------------------------------------
    # table construction (host-side, init only)
    # ------------------------------------------------------------------
    def _shard_info(self, s: int) -> Tuple[int, int, int]:
        ly, lx = self.partitioner.layout
        per_tile = ly * lx
        t = s // per_tile
        r = s % per_tile
        return t, r // lx, r % lx

    def _enumerate_points(self, stagger: str):
        """All array positions + their global chart coords + owned mask, per shard."""
        oy, ox = _STAGGER_OFFSETS[stagger]
        ny, nx = self.shard_shape(stagger)
        h = self.n_halo
        jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        out = []
        for s in range(self.n_shards):
            t, py, px = self._shard_info(s)
            gy = py * self.nsy + (jj - h) + oy
            gx = px * self.nsx + (ii - h) + ox
            if oy == 0.0:
                owned_y = (gy >= py * self.nsy) & (gy <= (py + 1) * self.nsy)
            else:
                owned_y = (gy > py * self.nsy) & (gy < (py + 1) * self.nsy)
            if ox == 0.0:
                owned_x = (gx >= px * self.nsx) & (gx <= (px + 1) * self.nsx)
            else:
                owned_x = (gx > px * self.nsx) & (gx < (px + 1) * self.nsx)
            owned = owned_y & owned_x
            out.append((s, t, jj, ii, gy, gx, owned))
        return out

    def _locate_source(self, t2, gy2, gx2):
        """Owning shard + local array indices for resolved global points.

        The stagger of each resolved point is inferred from its fractional
        parts (rotation can swap interface orientation).
        """
        h = self.n_halo
        fy = gy2 - np.floor(gy2)
        fx = gx2 - np.floor(gx2)
        # J index of the point in units of cells (integer for interface,
        # floor for half-integer locations)
        J2 = np.floor(gy2).astype(np.int64)
        I2 = np.floor(gx2).astype(np.int64)
        ly, lx = self.partitioner.layout
        # interface points exactly on internal shard boundaries are owned by
        # the lower shard (local index = ns)
        py = np.clip(
            np.where(fy < 0.25, np.maximum(J2 - 1, 0) // self.nsy, J2 // self.nsy),
            0,
            ly - 1,
        )
        px = np.clip(
            np.where(fx < 0.25, np.maximum(I2 - 1, 0) // self.nsx, I2 // self.nsx),
            0,
            lx - 1,
        )
        jl = J2 - py * self.nsy
        il = I2 - px * self.nsx
        s2 = (t2 * ly + py) * lx + px
        return s2, jl + h, il + h, fy, fx

    def _build_scalar(self, stagger: str, fold: str) -> _SubTable:
        rows = []
        for s, t, jj, ii, gy, gx, owned in self._enumerate_points(stagger):
            m = ~owned
            if not m.any():
                continue
            t2, gy2, gx2, _A, valid = self.topology.resolve_points(
                np.full(m.sum(), t), gy[m], gx[m], self.n_tile, corner_fold=fold
            )
            assert valid.all(), "unresolved ghost points in scalar halo table"
            s2, sj, si, fy, fx = self._locate_source(t2, gy2, gx2)
            oy, ox = _STAGGER_OFFSETS[stagger]
            # scalar staggers (center/corner) are rotation-invariant
            assert np.allclose(fy, oy) and np.allclose(fx, ox)
            block = np.stack(
                [
                    np.full(m.sum(), s),
                    jj[m],
                    ii[m],
                    s2,
                    sj,
                    si,
                    np.ones(m.sum()),
                ],
                axis=1,
            )
            rows.append(block)
        return _as_subtable(np.concatenate(rows, axis=0))

    def _build_vector(self, kind: str, fold: str):
        """Four subtables: (u<-u, u<-v, v<-u, v<-v)."""
        loc_u, dir_u, loc_v, dir_v = _VECTOR_KINDS[kind]
        tables = {("u", "u"): [], ("u", "v"): [], ("v", "u"): [], ("v", "v"): []}
        for comp, (loc, direction) in (
            ("u", (loc_u, dir_u)),
            ("v", (loc_v, dir_v)),
        ):
            d = np.asarray(direction)
            for s, t, jj, ii, gy, gx, owned in self._enumerate_points(loc):
                m = ~owned
                if not m.any():
                    continue
                npts = int(m.sum())
                t2, gy2, gx2, A, valid = self.topology.resolve_points(
                    np.full(npts, t), gy[m], gx[m], self.n_tile, corner_fold=fold
                )
                assert valid.all(), "unresolved ghost points in vector halo table"
                s2, sj, si, fy, fx = self._locate_source(t2, gy2, gx2)
                img = np.einsum("nij,j->ni", A, d)  # direction in source chart
                # x-direction source component is u for dgrid/agrid... in all
                # kinds the pair's first component is the x-direction wind, so:
                # image (0, ±1) -> source comp "u" with that sign;
                # image (±1, 0) -> source comp "v".
                from_u = np.abs(img[:, 1]) > 0.5
                sign = np.where(from_u, img[:, 1], img[:, 0])
                for src_comp, sel in (("u", from_u), ("v", ~from_u)):
                    if not sel.any():
                        continue
                    block = np.stack(
                        [
                            np.full(sel.sum(), s),
                            jj[m][sel],
                            ii[m][sel],
                            s2[sel],
                            sj[sel],
                            si[sel],
                            sign[sel],
                        ],
                        axis=1,
                    )
                    tables[(comp, src_comp)].append(block)
        out = {}
        for key, blocks in tables.items():
            out[key] = _as_subtable(
                np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 7))
            )
        return out

    def _build_interface_sync(self, kind: str):
        """Tables forcing tile-boundary interface points to a single owner value.

        Staggered vector components sampled exactly ON a tile boundary are
        computed independently by both adjacent tiles; without a sync their
        values (hence fluxes) disagree at roundoff-to-truncation level and
        break exact conservation. Convention: the edge's owner is the smaller
        ``(tile, edge)`` pair; the non-owner's copy is overwritten by the
        owner's value, rotated/sign-flipped into the local component basis.
        This is the analog of the reference communicator's interface-variable
        sync on shared edges (reference docs/util/communication.rst,
        ``synchronize_vector_interfaces``).
        """
        from .topology import EDGE_W, EDGE_E, EDGE_S, EDGE_N

        loc_u, dir_u, loc_v, dir_v = _VECTOR_KINDS[kind]
        n = self.n_tile
        tables = {("u", "u"): [], ("u", "v"): [], ("v", "u"): [], ("v", "v"): []}
        for comp, (loc, direction) in (
            ("u", (loc_u, dir_u)),
            ("v", (loc_v, dir_v)),
        ):
            d = np.asarray(direction)
            oy, ox = _STAGGER_OFFSETS[loc]
            for s, t, jj, ii, gy, gx, owned in self._enumerate_points(loc):
                # points exactly on a tile boundary along this loc's interface
                # axis (x-interfaces lie on W/E edges, y-interfaces on S/N)
                if ox == 0.0 and oy != 0.0:
                    on_edge = {EDGE_W: gx == 0.0, EDGE_E: gx == float(n)}
                elif oy == 0.0 and ox != 0.0:
                    on_edge = {EDGE_S: gy == 0.0, EDGE_N: gy == float(n)}
                else:
                    continue  # center/corner staggers handled elsewhere
                for e, me in on_edge.items():
                    m = me & owned
                    if not m.any():
                        continue
                    rel = self.topology.adjacency[(t, e)]
                    if (t, e) <= (rel.neighbor_tile, rel.neighbor_edge):
                        continue  # this side owns the edge; keep own values
                    A, b = self.topology.edge_affine(t, e, n)
                    gy2 = A[0, 0] * gy[m] + A[0, 1] * gx[m] + b[0]
                    gx2 = A[1, 0] * gy[m] + A[1, 1] * gx[m] + b[1]
                    t2 = np.full(int(m.sum()), rel.neighbor_tile)
                    s2, sj, si, _fy, _fx = self._locate_source(t2, gy2, gx2)
                    img = A @ d
                    # x-direction image -> source u component, y -> v
                    if abs(img[1]) > 0.5:
                        src_comp, sign = "u", img[1]
                    else:
                        src_comp, sign = "v", img[0]
                    block = np.stack(
                        [
                            np.full(int(m.sum()), s),
                            jj[m],
                            ii[m],
                            s2,
                            sj,
                            si,
                            np.full(int(m.sum()), sign),
                        ],
                        axis=1,
                    )
                    tables[(comp, src_comp)].append(block)
        out = {}
        for key, blocks in tables.items():
            out[key] = _as_subtable(
                np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 7))
            )
        return out

    def scalar_table(self, stagger: str = "center", fold: str = "x") -> _SubTable:
        key = (stagger, fold)
        if key not in self._scalar_tables:
            self._scalar_tables[key] = self._build_scalar(stagger, fold)
        return self._scalar_tables[key]

    def vector_tables(self, kind: str = "dgrid", fold: str = "x"):
        key = (kind, fold)
        if key not in self._vector_tables:
            self._vector_tables[key] = self._build_vector(kind, fold)
        return self._vector_tables[key]

    def sync_tables(self, kind: str = "dgrid"):
        if kind not in self._sync_tables:
            self._sync_tables[kind] = self._build_interface_sync(kind)
        return self._sync_tables[kind]

    # ------------------------------------------------------------------
    # application (slab region ops; CUDA kernel or plain strip updates)
    # ------------------------------------------------------------------
    @property
    def slabs(self):
        """The slab-compiled exchange (region ops + their application)."""
        if not hasattr(self, "_slab_impl"):
            from .halo_slabs import SlabHalo

            self._slab_impl = SlabHalo(self)
        return self._slab_impl

    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        """Fill ghost cells of a scalar field ``q``: (S, ..., Y, X) -> same."""
        return self.slabs.update_scalar(q, stagger=stagger, fold=fold)

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        """Fill ghost cells of a staggered vector pair with rotation/sign flips."""
        return self.slabs.update_vector(u, v, kind=kind, fold=fold)

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        """Fill ghost cells of several same-shaped scalar fields."""
        return self.slabs.update_scalars(qs, stagger=stagger, fold=fold)

    def update_scalar_folds(self, q, stagger: str = "center"):
        """(q with x-fold corners, q with y-fold corners)."""
        return self.slabs.update_scalar_folds(q, stagger=stagger)

    def update_vector_folds(self, u, v, kind: str = "dgrid"):
        """((u_x, v_x), (u_y, v_y))."""
        return self.slabs.update_vector_folds(u, v, kind=kind)

    def update_vector_fold_pair(
        self, u, v, kind: str = "dgrid", fold_u: str = "y", fold_v: str = "x"
    ):
        """(u in fold_u, v in fold_v) — only the consumed folds."""
        return self.slabs.update_vector_fold_pair(
            u, v, kind=kind, fold_u=fold_u, fold_v=fold_v
        )

    def update_scalar_fold_patch(self, q, stagger: str = "center"):
        """(q_xfold, y_corner_patch) — see SlabHalo.update_scalar_fold_patch."""
        return self.slabs.update_scalar_fold_patch(q, stagger=stagger)

    def update_scalars_fold_patches(self, qs, stagger: str = "center"):
        """[(qi_xfold, yi_corner_patch)] for several same-shaped fields."""
        return self.slabs.update_scalars_fold_patches(qs, stagger=stagger)

    def start_update_scalars_fold_patches(self, qs, stagger: str = "center"):
        """Start the fold-patch exchange of several fields; ``.wait()`` on
        the returned handle gives the pairs."""
        return self.slabs.start_update_scalars_fold_patches(qs, stagger=stagger)

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        """Force tile-boundary interface values of (u, v) to the edge owner's.

        Use on staggered winds after they are updated independently per shard,
        and on (fx, fy) interface fluxes (kind="cgrid") to make cross-edge
        fluxes single-valued — the exact-conservation guarantee.
        """
        return self.slabs.sync_vector_interfaces(u, v, kind=kind)
