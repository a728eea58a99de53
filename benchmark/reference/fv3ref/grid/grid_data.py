"""GridData: device-resident metric terms consumed by the solver ops.

Port of ``pace_tpu.grid.grid_data`` (analog of NDSL's ``GridData`` views over
MetricTerms, reference driver/pace/driver/grid.py:123-141). One flat frozen
dataclass of torch tensors stacked per shard ``(S, ..., Y, X)`` on one
device, built from :class:`~pace_tpu_torch.grid.generation.MetricTerms`
(:meth:`GridData.from_metric_terms`) or from the same fields given as numpy
arrays (:meth:`GridData.from_numpy`, e.g. a ``pace_tpu`` grid).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..dtypes import check_dtype, resolve_device, to_tensor

from .generation import MetricTerms, SG_CENTER, SG_W, SG_E, SG_S, SG_N

_TINY = 1e-8

#: fields that are metadata, not tensors
_STATIC_FIELDS = ("ptop", "n_halo", "npz", "da_min", "da_min_c", "corner_table")
#: tensors of the vertical coordinate, the same for every shard
_COLUMN_FIELDS = ("ak", "bk")


def _band(mask: np.ndarray, axis: int, width: int = 2) -> np.ndarray:
    """Widen a 0/1 mask by ``width`` on each side along ``axis``."""
    out = mask.copy()
    for d in range(1, width + 1):
        out = out + np.roll(mask, d, axis=axis) + np.roll(mask, -d, axis=axis)
    return (out > 0).astype(mask.dtype)


def _center_band(
    edge_x_iface: np.ndarray, edge_y_iface: np.ndarray, Ys: int, Xs: int
) -> np.ndarray:
    """Cells within 2 of a tile edge in either direction: (S, Y, X)."""
    S = edge_x_iface.shape[0]
    bx = np.zeros((S, 1, Xs))
    for s in range(S):
        cols = np.nonzero(edge_x_iface[s, 0])[0]
        for c in cols:
            lo = max(c - 3, 0)
            hi = min(c + 3, Xs)
            bx[s, 0, lo:hi] = 1.0
    by = np.zeros((S, Ys, 1))
    for s in range(S):
        rows = np.nonzero(edge_y_iface[s, :, 0])[0]
        for r in rows:
            lo = max(r - 3, 0)
            hi = min(r + 3, Ys)
            by[s, lo:hi, 0] = 1.0
    return ((bx + by) > 0).astype(np.float64) * np.ones((S, Ys, Xs))


def _wind_solve_minv(mt: MetricTerms) -> np.ndarray:
    """Per-cell inverse normal matrix for the covariant->Cartesian wind solve.

    Samples: the D-grid covariant winds on the cell's four faces — u at the
    two y-interfaces (basis es1 there) and v at the two x-interfaces (basis
    ew2). M = sum_k e_k e_k^T + r r^T (the radial term regularizes the
    tangent-plane rank-2 system; V has no radial component so it does not
    bias the solution). Returns (S, 3, 3, Y, X).
    """
    es1 = mt.es1  # (S, Y+1, X, 3)
    ew2 = mt.ew2  # (S, Y, X+1, 3)
    r = mt.xyz_center  # (S, Y, X, 3) unit radial
    if np.abs(r).max() == 0.0:  # doubly-periodic plane: use z as "radial"
        r = np.zeros_like(r)
        r[..., 2] = 1.0

    def outer(e):
        return e[..., :, None] * e[..., None, :]

    M = (
        outer(es1[:, :-1, :])
        + outer(es1[:, 1:, :])
        + outer(ew2[:, :, :-1])
        + outer(ew2[:, :, 1:])
        + outer(r)
    )  # (S, Y, X, 3, 3)
    minv = np.linalg.inv(M)
    return np.moveaxis(minv, (-2, -1), (1, 2))  # (S, 3, 3, Y, X)


@dataclasses.dataclass(frozen=True)
class GridData:
    """Device metric terms. Shapes: Y/X are halo-inclusive cell counts; +1 on
    an axis indicates interface staggering along it."""

    # lengths [m] and reciprocals
    dx: torch.Tensor  # (S, Y+1, X) cell edge lengths along x at y-interfaces
    dy: torch.Tensor  # (S, Y, X+1)
    dxa: torch.Tensor  # (S, Y, X)
    dya: torch.Tensor
    dxc: torch.Tensor  # (S, Y, X+1)
    dyc: torch.Tensor  # (S, Y+1, X)
    rdx: torch.Tensor
    rdy: torch.Tensor
    rdxa: torch.Tensor
    rdya: torch.Tensor
    rdxc: torch.Tensor
    rdyc: torch.Tensor

    # areas
    area: torch.Tensor  # (S, Y, X)
    rarea: torch.Tensor
    area_c: torch.Tensor  # (S, Y+1, X+1)
    rarea_c: torch.Tensor

    # angles (grid-line crossing angles at each staggering)
    cosa: torch.Tensor  # (S, Y+1, X+1) corners
    sina: torch.Tensor
    cosa_u: torch.Tensor  # (S, Y, X+1) x-interface (u/C-grid-u points)
    sina_u: torch.Tensor
    rsin_u2: torch.Tensor  # 1 / sina_u^2
    cosa_v: torch.Tensor  # (S, Y+1, X) y-interface
    sina_v: torch.Tensor
    rsin_v2: torch.Tensor
    cosa_s: torch.Tensor  # (S, Y, X) centers
    rsin2: torch.Tensor  # 1 / sin^2 at centers
    rsina2: torch.Tensor  # 1 / sina^2 at corners

    # supergrid sin values used for face-flux projection
    sin_sg_w: torch.Tensor  # (S, Y, X) sin of angle at west face of each cell
    sin_sg_e: torch.Tensor
    sin_sg_s: torch.Tensor
    sin_sg_n: torch.Tensor
    cos_sg_w: torch.Tensor
    cos_sg_e: torch.Tensor
    cos_sg_s: torch.Tensor
    cos_sg_n: torch.Tensor

    # Coriolis parameter
    f0: torch.Tensor  # (S, Y, X) centers
    fC: torch.Tensor  # (S, Y+1, X+1) corners
    lat_agrid: torch.Tensor  # (S, Y, X) cell-center latitude [rad]
    lon_agrid: torch.Tensor  # (S, Y, X) cell-center longitude [rad]

    # vertical coordinate
    ak: torch.Tensor  # (npz+1,)
    bk: torch.Tensor

    # edge masks (1.0 on shards' rows/cols adjacent to a cube edge, else 0.0)
    # *_iface masks mark the tile-boundary interface lines themselves.
    edge_w_iface: torch.Tensor  # (S, 1, X+1) 1 where x-interface ii is a tile W edge
    edge_e_iface: torch.Tensor
    edge_s_iface: torch.Tensor  # (S, Y+1, 1)
    edge_n_iface: torch.Tensor
    # band masks: 1.0 on interfaces whose interpolation stencil crosses a tile
    # edge (edge column/row +- 2)
    edge_band_x: torch.Tensor  # (S, 1, X+1)
    edge_band_y: torch.Tensor  # (S, Y+1, 1)
    # along-edge ghost-correction weights for a2b_ord4 on tile-edge
    # interface lines (the reference's edge_vect_w/e/s/n metric treatment):
    # the neighbor tile's cell-center rows are skewed ALONG the edge
    # relative to this tile's (up to ~0.5 cells near cube corners), so the
    # ghost column must be interpolated along-edge before the across-edge
    # average. q_ghost_corrected = w0*ghost + wp*roll(ghost, -1, along) +
    # wm*roll(ghost, +1, along); valid on tile-edge interface lines only.
    # ghost_left_x = 1 where the ghost cell is on the LEFT (W edges).
    a2b_x_w0: torch.Tensor  # (S, Y, X+1)
    a2b_x_wp: torch.Tensor
    a2b_x_wm: torch.Tensor
    a2b_ghost_left_x: torch.Tensor  # (S, 1, X+1)
    a2b_y_w0: torch.Tensor  # (S, Y+1, X)
    a2b_y_wp: torch.Tensor
    a2b_y_wm: torch.Tensor
    a2b_ghost_south_y: torch.Tensor  # (S, Y+1, 1)

    # unit local basis 3-vectors (for kink-safe vector interpolation at tile
    # edges and lat-lon wind conversion); component axis FIRST after S so the
    # trailing axes stay (Y, X) for the stencil helpers
    ec1: torch.Tensor  # (S, 3, Y, X) x-basis at centers
    ec2: torch.Tensor  # y-basis at centers
    ew1: torch.Tensor  # (S, 3, Y, X+1) x-basis at x-interfaces
    ew2: torch.Tensor
    es1: torch.Tensor  # (S, 3, Y+1, X) x-basis at y-interfaces
    es2: torch.Tensor
    # center band mask: cells whose 4-pt interp stencil crosses a tile edge
    band_c: torch.Tensor  # (S, Y, X)
    # cube-corner point masks (corner stagger, (S, Y+1, X+1)): 1.0 where the
    # corner point is a 3-valent cube corner, by which tile quadrant is real
    corner_sw: torch.Tensor  # tile occupies the NE quadrant of the point
    corner_se: torch.Tensor  # tile occupies NW
    corner_nw: torch.Tensor  # tile occupies SE
    corner_ne: torch.Tensor  # tile occupies SW
    # inverse normal matrices of the per-cell covariant->Cartesian wind solve:
    # V = minv @ (sum_k sample_k * basis_k); radial direction regularized out
    minv: torch.Tensor  # (S, 3, 3, Y, X)

    # static metadata
    ptop: float = dataclasses.field(default=0.0)
    n_halo: int = dataclasses.field(default=3)
    npz: int = dataclasses.field(default=79)
    da_min: float = dataclasses.field(default=0.0)
    da_min_c: float = dataclasses.field(default=0.0)
    #: static cube-corner point table: tuple of (kind, jj, ii, own) where
    #: kind in {"sw","se","nw","ne"}, (jj, ii) is the local corner-stagger
    #: index of a 3-valent cube corner, and own is an S-tuple of bools naming
    #: the shards for which that point is a cube corner. Lets the corner ops
    #: apply point fixes with static indices (cheap dynamic-update-slices)
    #: instead of full-array masked selects — see ops/corners.py.
    corner_table: tuple = dataclasses.field(default=())

    @classmethod
    def from_metric_terms(
        cls, mt: MetricTerms, device="cuda", dtype=torch.float32
    ) -> "GridData":
        """Device grid from generated metric terms."""
        dev = resolve_device(device)
        check_dtype(dtype)
        spec = mt.spec
        halo = mt.halo
        h = spec.n_halo
        S = halo.n_shards
        Ys, Xs = halo.nsy + 2 * h, halo.nsx + 2 * h

        def j(a):
            return to_tensor(a, dev, dtype)

        sin_sg = mt.sin_sg
        cos_sg = mt.cos_sg

        # --- tile-edge interface masks (host-side numpy, baked as constants)
        edge_w = np.zeros((S, 1, Xs + 1))
        edge_e = np.zeros((S, 1, Xs + 1))
        edge_s = np.zeros((S, Ys + 1, 1))
        edge_n = np.zeros((S, Ys + 1, 1))
        corner_masks = np.zeros((4, S, Ys + 1, Xs + 1))
        n = spec.n_tile
        if spec.grid_type != 4:  # the doubly-periodic plane has no edges
            for s in range(S):
                _t, py, px = halo._shard_info(s)
                # global x-interface coordinate of array index ii is
                # px * nsx + (ii - h); tile W edge at 0, E edge at n.
                gx0 = px * halo.nsx - h
                for ii in range(Xs + 1):
                    if gx0 + ii == 0:
                        edge_w[s, 0, ii] = 1.0
                    if gx0 + ii == n:
                        edge_e[s, 0, ii] = 1.0
                gy0 = py * halo.nsy - h
                for jj in range(Ys + 1):
                    if gy0 + jj == 0:
                        edge_s[s, jj, 0] = 1.0
                    if gy0 + jj == n:
                        edge_n[s, jj, 0] = 1.0
                # cube-corner points owned by this shard
                for kind, (gy, gx) in enumerate(
                    [(0, 0), (0, n), (n, 0), (n, n)]  # sw, se, nw, ne
                ):
                    jj = gy - gy0
                    ii = gx - gx0
                    if 0 <= jj <= Ys and 0 <= ii <= Xs:
                        corner_masks[kind, s, jj, ii] = 1.0

        # --- a2b edge_vect analog: at a tile-edge interface line the ghost
        # (neighbor-tile) cell-center rows are skewed ALONG the edge (up to
        # ~0.5 cells near cube corners — the adjacent face's spacing
        # differs), so interpolating straight across the kink misplaces the
        # value by the skew * the along-edge gradient (measured: 30x the
        # interior a2b error, driving a stationary ~10 hPa cube-corner
        # surface-pressure anomaly). Correction: interpolate the ghost
        # column along the edge so the 2-point geodesic midpoint lands on
        # the interface point. Ghost positions are TRUE neighbor positions
        # (topology-resolved at generation), so the shift is computable
        # exactly here.
        def _gc(a, b):
            return np.arccos(np.clip(np.sum(a * b, axis=-1), -1.0, 1.0))

        def _edge_vect_weights(c_in, c_gh, p_edge, tangent):
            """(w0, wp, wm) per along-edge row: ghost-column interpolation
            weights so that mid(c_in, ghost_interp) sits on the edge line.
            wp weights roll(ghost, -1) (the next row), wm the previous."""
            m = c_in + c_gh
            m = m / np.maximum(
                np.linalg.norm(m, axis=-1, keepdims=True), 1e-30
            )
            delta = np.sum((m - p_edge) * tangent, axis=-1)  # signed, rad
            npts = c_gh.shape[0]
            hg_fwd = np.empty(npts)
            hg_fwd[:-1] = _gc(c_gh[:-1], c_gh[1:])
            hg_fwd[-1] = hg_fwd[-2]
            hg_bwd = np.empty(npts)
            hg_bwd[1:] = hg_fwd[:-1]
            hg_bwd[0] = hg_bwd[1]
            # midpoint moves by half the ghost shift: shift = -2*delta
            t = -2.0 * delta / np.where(delta <= 0.0, hg_fwd, hg_bwd)
            a = np.clip(np.abs(t), 0.0, 1.0)
            wp = np.where(t > 0.0, a, 0.0)
            wm = np.where(t < 0.0, a, 0.0)
            return 1.0 - a, wp, wm

        ctr = mt.xyz_center  # (S, Ys, Xs, 3)
        a2b_x_w0 = np.ones((S, Ys, Xs + 1))
        a2b_x_wp = np.zeros((S, Ys, Xs + 1))
        a2b_x_wm = np.zeros((S, Ys, Xs + 1))
        a2b_gl_x = np.zeros((S, 1, Xs + 1))
        a2b_y_w0 = np.ones((S, Ys + 1, Xs))
        a2b_y_wp = np.zeros((S, Ys + 1, Xs))
        a2b_y_wm = np.zeros((S, Ys + 1, Xs))
        a2b_gs_y = np.zeros((S, Ys + 1, 1))
        for s in range(S):
            for ii in range(1, Xs):
                is_w = edge_w[s, 0, ii] > 0
                is_e = edge_e[s, 0, ii] > 0
                if not (is_w or is_e):
                    continue
                # tangent along the edge (y direction) at interface points
                tcol = mt.xyz_corner[s, :, ii]  # (Ys+1, 3)
                tang = tcol[1:] - tcol[:-1]
                tang = tang / np.maximum(
                    np.linalg.norm(tang, axis=-1, keepdims=True), 1e-30
                )
                gh_col = ii - 1 if is_w else ii
                in_col = ii if is_w else ii - 1
                w0, wp, wm = _edge_vect_weights(
                    ctr[s, :, in_col], ctr[s, :, gh_col],
                    mt.xyz_v[s, :, ii], tang,
                )
                a2b_x_w0[s, :, ii] = w0
                a2b_x_wp[s, :, ii] = wp
                a2b_x_wm[s, :, ii] = wm
                if is_w:
                    a2b_gl_x[s, 0, ii] = 1.0
            for jj in range(1, Ys):
                is_s = edge_s[s, jj, 0] > 0
                is_n = edge_n[s, jj, 0] > 0
                if not (is_s or is_n):
                    continue
                trow = mt.xyz_corner[s, jj, :]  # (Xs+1, 3)
                tang = trow[1:] - trow[:-1]
                tang = tang / np.maximum(
                    np.linalg.norm(tang, axis=-1, keepdims=True), 1e-30
                )
                gh_row = jj - 1 if is_s else jj
                in_row = jj if is_s else jj - 1
                w0, wp, wm = _edge_vect_weights(
                    ctr[s, in_row, :], ctr[s, gh_row, :],
                    mt.xyz_u[s, jj, :], tang,
                )
                a2b_y_w0[s, jj, :] = w0
                a2b_y_wp[s, jj, :] = wp
                a2b_y_wm[s, jj, :] = wm
                if is_s:
                    a2b_gs_y[s, jj, 0] = 1.0

        # static corner table: same content as corner_masks, grouped by
        # (kind, position) with per-shard ownership flags
        corner_entries = []
        kind_names = ("sw", "se", "nw", "ne")
        for kind in range(4):
            by_pos: dict = {}
            for s in range(S):
                js, iis = np.nonzero(corner_masks[kind, s])
                for jj, ii in zip(js.tolist(), iis.tolist()):
                    by_pos.setdefault((jj, ii), set()).add(s)
            for (jj, ii), owners in sorted(by_pos.items()):
                own = tuple(s in owners for s in range(S))
                corner_entries.append((kind_names[kind], jj, ii, own))

        return cls(
            dx=j(mt.dx),
            dy=j(mt.dy),
            dxa=j(mt.dxa),
            dya=j(mt.dya),
            dxc=j(mt.dxc),
            dyc=j(mt.dyc),
            rdx=j(mt.rdx),
            rdy=j(mt.rdy),
            rdxa=j(mt.rdxa),
            rdya=j(mt.rdya),
            rdxc=j(mt.rdxc),
            rdyc=j(mt.rdyc),
            area=j(mt.area),
            rarea=j(mt.rarea),
            area_c=j(mt.area_c),
            rarea_c=j(mt.rarea_c),
            cosa=j(mt.cosa),
            sina=j(mt.sina),
            cosa_u=j(mt.cosa_v),  # note: MetricTerms cosa_v is at x-interfaces
            sina_u=j(mt.sina_v),
            rsin_u2=j(1.0 / np.maximum(mt.sina_v**2, _TINY)),
            cosa_v=j(mt.cosa_u),  # MetricTerms cosa_u is at y-interfaces
            sina_v=j(mt.sina_u),
            rsin_v2=j(1.0 / np.maximum(mt.sina_u**2, _TINY)),
            cosa_s=j(mt.cosa_s),
            rsin2=j(mt.rsin2),
            rsina2=j(1.0 / np.maximum(mt.sina**2, _TINY)),
            sin_sg_w=j(sin_sg[:, SG_W]),
            sin_sg_e=j(sin_sg[:, SG_E]),
            sin_sg_s=j(sin_sg[:, SG_S]),
            sin_sg_n=j(sin_sg[:, SG_N]),
            cos_sg_w=j(cos_sg[:, SG_W]),
            cos_sg_e=j(cos_sg[:, SG_E]),
            cos_sg_s=j(cos_sg[:, SG_S]),
            cos_sg_n=j(cos_sg[:, SG_N]),
            f0=j(mt.f0),
            fC=j(mt.fC),
            lat_agrid=j(mt.lat_agrid),
            lon_agrid=j(mt.lon_agrid),
            ak=j(mt.ak),
            bk=j(mt.bk),
            edge_w_iface=j(edge_w),
            edge_e_iface=j(edge_e),
            edge_s_iface=j(edge_s),
            edge_n_iface=j(edge_n),
            a2b_x_w0=j(a2b_x_w0),
            a2b_x_wp=j(a2b_x_wp),
            a2b_x_wm=j(a2b_x_wm),
            a2b_ghost_left_x=j(a2b_gl_x),
            a2b_y_w0=j(a2b_y_w0),
            a2b_y_wp=j(a2b_y_wp),
            a2b_y_wm=j(a2b_y_wm),
            a2b_ghost_south_y=j(a2b_gs_y),
            edge_band_x=j(_band(edge_w + edge_e, axis=2)),
            edge_band_y=j(_band(edge_s + edge_n, axis=1)),
            ec1=j(np.moveaxis(mt.ec1, -1, 1)),
            ec2=j(np.moveaxis(mt.ec2, -1, 1)),
            ew1=j(np.moveaxis(mt.ew1, -1, 1)),
            ew2=j(np.moveaxis(mt.ew2, -1, 1)),
            es1=j(np.moveaxis(mt.es1, -1, 1)),
            es2=j(np.moveaxis(mt.es2, -1, 1)),
            band_c=j(_center_band(edge_w + edge_e, edge_s + edge_n, Ys, Xs)),
            minv=j(_wind_solve_minv(mt)),
            corner_sw=j(corner_masks[0]),
            corner_se=j(corner_masks[1]),
            corner_nw=j(corner_masks[2]),
            corner_ne=j(corner_masks[3]),
            corner_table=tuple(corner_entries),
            ptop=float(mt.ak[0]),
            n_halo=h,
            npz=spec.npz,
            da_min=float(mt.area[:, h:-h, h:-h].min()),
            da_min_c=float(mt.area_c[:, h + 1 : -h - 1, h + 1 : -h - 1].min()),
        )

    def shard_block(self, lo: int, hi: int, n_shards: int) -> "GridData":
        """The grid of shards ``[lo, hi)`` of ``n_shards`` (a rank's block on
        the mesh, ``parallel/mesh.py``): every S-leading field cut to the
        block, and each ``corner_table`` entry's ``own`` too, the entries no
        shard of the block owns left out. ``da_min`` and ``da_min_c`` stay
        the whole cube's."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in _STATIC_FIELDS or f.name in _COLUMN_FIELDS:
                continue
            if v.shape[0] != n_shards:
                raise ValueError(f"GridData.{f.name} has {v.shape[0]} shards, not {n_shards}")
            changes[f.name] = v[lo:hi].contiguous()
        changes["corner_table"] = tuple(
            (kind, jj, ii, own[lo:hi]) for kind, jj, ii, own in self.corner_table
            if any(own[lo:hi]))
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda", dtype=torch.float32) -> "GridData":
        """Device grid from its fields as numpy arrays, keyed by field name
        (e.g. ``{f: np.asarray(getattr(g, f))}`` of a ``pace_tpu``
        ``GridData``); the static fields are taken as given."""
        dev = resolve_device(device)
        check_dtype(dtype)
        kw = {}
        for f in dataclasses.fields(cls):
            v = arrays[f.name]
            if f.name in _STATIC_FIELDS:
                kw[f.name] = v
            else:
                kw[f.name] = to_tensor(v, dev, dtype)
        return cls(**kw)

    # ------------------------------------------------------------------
    # divergence-damping gradient weights (reference MetricTerms.divg_u /
    # divg_v; verified fields in reference
    # tests/mpi_54rank/test_grid_init.py:92-93). Computed from the resident
    # fields on demand:
    # the same sina-weighted metric the corner-divergence operator uses,
    # with the one-sided supergrid sines on tile-edge lines — so the del-n
    # damping chain iterates a Laplacian CONSISTENT with its divergence.
    def divg_u(self):
        """(S, Y+1, X) weight for corner differences along x (u-lines):
        sina_v * dyc / dx; tile-edge rows use the one-sided supergrid
        sines 0.5*(sin_sg_n(j-1) + sin_sg_s(j)) exactly as
        ops.c_sw.divergence_corner does."""
        from ..ops.stencil_utils import (
            y_cell_to_left_iface,
            y_cell_to_right_iface,
        )

        sin_edge = 0.5 * (
            y_cell_to_left_iface(self.sin_sg_n)
            + y_cell_to_right_iface(self.sin_sg_s)
        )
        edge_y = torch.clamp(self.edge_s_iface + self.edge_n_iface, 0.0, 1.0)
        sina = torch.where(edge_y > 0.0, sin_edge, self.sina_v)
        return sina * self.dyc * self.rdx

    def divg_v(self):
        """(S, Y, X+1) weight for corner differences along y (v-lines):
        sina_u * dxc / dy; tile-edge columns one-sided as in
        divergence_corner."""
        from ..ops.stencil_utils import (
            x_cell_to_left_iface,
            x_cell_to_right_iface,
        )

        sin_edge = 0.5 * (
            x_cell_to_left_iface(self.sin_sg_e)
            + x_cell_to_right_iface(self.sin_sg_w)
        )
        edge_x = torch.clamp(self.edge_w_iface + self.edge_e_iface, 0.0, 1.0)
        sina = torch.where(edge_x > 0.0, sin_edge, self.sina_u)
        return sina * self.dxc * self.rdy
