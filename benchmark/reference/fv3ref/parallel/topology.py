"""Cubed-sphere tile topology: adjacency, edge transforms, ghost-point resolution.

TPU-native re-design of the reference's partitioner/boundary layer
(``ndsl.comm.partitioner`` — Boundary objects with ``n_clockwise_rotations``; see
reference docs/util/communication.rst and SURVEY.md §2.2). Instead of hand-encoded
rotation tables, this module *derives* the tile adjacency and the exact affine
index transforms numerically from the cube geometry at init time. All results are
static integer tables, which downstream code bakes into XLA programs as constants.

Key ideas
---------
- Each tile is a chart with continuous coordinates ``(y, x) ∈ [0, n]²`` (cell units).
  Cell centers sit at half-integers, interfaces at integers.
- For each tile edge we derive an exact affine map ``T(q) = A q + b`` into the
  neighbor tile's chart (``A`` a signed 0/±1 rotation matrix, ``b`` integral).
- A ghost point outside the chart is resolved by applying edge maps (at most two
  hops). Points outside in *both* directions (corner regions) are ambiguous at
  tile corners — the fold direction must be chosen. ``corner_fold="x"`` resolves
  through the y-edge first (producing corner data consistent with x-direction
  sweeps — the analog of the reference's ``copy_corners`` x-variant), ``"y"``
  the transpose. Unlike the reference (which leaves tile-corner halos invalid and
  copies data in a fold convention), the resolved values here are the *true*
  field values at the physical ghost location of the chosen fold.
- The accumulated rotation ``A`` also transforms vector components: the reference's
  vector-halo "rotation + sign flip" trick falls out of ``A``'s columns.

A doubly-periodic single-tile topology (reference grid_type=4; driver/pace/driver/
grid.py:32-319 ``GeneratedGridConfig``) uses the same machinery with a 1-tile
adjacency wrapping each edge to its opposite.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

EDGE_W, EDGE_E, EDGE_S, EDGE_N = 0, 1, 2, 3
EDGE_NAMES = ("W", "E", "S", "N")

# In (y, x) coordinates:
_D_OUT = {
    EDGE_W: np.array([0.0, -1.0]),
    EDGE_E: np.array([0.0, 1.0]),
    EDGE_S: np.array([-1.0, 0.0]),
    EDGE_N: np.array([1.0, 0.0]),
}
_TANGENT = {
    EDGE_W: np.array([1.0, 0.0]),
    EDGE_E: np.array([1.0, 0.0]),
    EDGE_S: np.array([0.0, 1.0]),
    EDGE_N: np.array([0.0, 1.0]),
}
# midpoints in unit coords (y, x) ∈ [0,1]²
_MID = {
    EDGE_W: np.array([0.5, 0.0]),
    EDGE_E: np.array([0.5, 1.0]),
    EDGE_S: np.array([0.0, 0.5]),
    EDGE_N: np.array([1.0, 0.5]),
}


def cube_face_frames() -> list:
    """Orthonormal (u, v, n) frames of the 6 cube faces, FV3-style ordering:
    tiles 0,1 equatorial, 2 north polar, 3,4 equatorial, 5 south polar.
    Each frame is right-handed: u × v = n (outward normal); the chart point is
    p(y, x) = n + (2x-1)·u + (2y-1)·v on the cube surface.
    """
    ex = np.array([1.0, 0.0, 0.0])
    ey = np.array([0.0, 1.0, 0.0])
    ez = np.array([0.0, 0.0, 1.0])
    return [
        (ey, ez, ex),  # tile 0: +x face, x→east, y→north
        (-ex, ez, ey),  # tile 1: +y face
        (ey, -ex, ez),  # tile 2: north polar (+z)
        (-ey, ez, -ex),  # tile 3: -x face
        (ex, ez, -ey),  # tile 4: -y face
        (ey, ex, -ez),  # tile 5: south polar (-z)
    ]


def cube_surface_point(tile: int, y, x, n: float = 1.0) -> np.ndarray:
    """3D point on the (unprojected) cube surface for chart coords in [0, n]."""
    u, v, nrm = cube_face_frames()[tile]
    a = 2.0 * np.asarray(x) / n - 1.0
    b = 2.0 * np.asarray(y) / n - 1.0
    return (
        nrm[..., :]
        + a[..., None] * u[..., :]
        + b[..., None] * v[..., :]
    )


@dataclasses.dataclass(frozen=True)
class EdgeRelation:
    """Edge ``edge`` of a tile connects to ``neighbor_edge`` of ``neighbor_tile``;
    ``flip`` is True when the shared edge's parameterization reverses."""

    neighbor_tile: int
    neighbor_edge: int
    flip: bool


class Topology:
    """Tile connectivity + exact chart-to-chart edge transforms."""

    def __init__(self, adjacency: Dict[Tuple[int, int], EdgeRelation], n_tiles: int):
        self.adjacency = adjacency
        self.n_tiles = n_tiles
        # Precompute unit-coordinate affine maps (A, b_unit); cell-unit offset is
        # b_unit * n.
        self._affines: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for (tile, edge), rel in adjacency.items():
            d_out = _D_OUT[edge]
            tau = _TANGENT[edge]
            d_in2 = -_D_OUT[rel.neighbor_edge]
            tau2 = _TANGENT[rel.neighbor_edge]
            sigma = -1.0 if rel.flip else 1.0
            A = np.outer(d_in2, d_out) + sigma * np.outer(tau2, tau)
            b_unit = _MID[rel.neighbor_edge] - A @ _MID[edge]
            assert abs(np.linalg.det(A) - 1.0) < 1e-12, (
                "edge transform must be a proper rotation"
            )
            self._affines[(tile, edge)] = (
                A.astype(np.float64),
                b_unit.astype(np.float64),
            )

    def edge_affine(self, tile: int, edge: int, n: int):
        """(A, b) mapping tile chart coords (cell units, [0,n]) to neighbor chart."""
        A, b_unit = self._affines[(tile, edge)]
        return A, b_unit * n

    def resolve_points(
        self,
        tile: np.ndarray,
        y: np.ndarray,
        x: np.ndarray,
        n: int,
        corner_fold: str = "x",
    ):
        """Map ghost points (outside [0,n]²) to their source chart points.

        Parameters
        ----------
        tile, y, x:
            integer tile ids and continuous chart coords (cell units), any shape.
        n:
            tile extent in cells.
        corner_fold:
            "x" → corner regions resolve through the y-edge first (x-sweep
            consistent, reference ``copy_corners`` x-variant analog), "y" → the
            transpose.

        Returns
        -------
        (tile2, y2, x2, A_acc, valid):
            resolved tile/coords, the accumulated 2x2 rotation per point
            (shape ``(..., 2, 2)``) mapping source-chart directions FROM the
            original chart, and validity mask.
        """
        if corner_fold not in ("x", "y"):
            raise ValueError(f"corner_fold must be 'x' or 'y', got {corner_fold}")
        tile = np.array(tile, dtype=np.int64)
        y = np.array(y, dtype=np.float64)
        x = np.array(x, dtype=np.float64)
        shape = np.broadcast(tile, y, x).shape
        tile = np.broadcast_to(tile, shape).copy()
        y = np.broadcast_to(y, shape).copy()
        x = np.broadcast_to(x, shape).copy()
        A_acc = np.broadcast_to(np.eye(2), shape + (2, 2)).copy()
        eps = 1e-9
        for _hop in range(3):
            out_w = x < -eps
            out_e = x > n + eps
            out_s = y < -eps
            out_n = y > n + eps
            out_x = out_w | out_e
            out_y = out_s | out_n
            need = out_x | out_y
            if not need.any():
                break
            if corner_fold == "x":
                use_y_edge = out_y
            else:
                use_y_edge = out_y & ~out_x
            edge_sel = np.where(
                use_y_edge,
                np.where(out_s, EDGE_S, EDGE_N),
                np.where(out_w, EDGE_W, EDGE_E),
            )
            # each point is transformed at most once per hop (the tile id
            # mutates in place, so later masks must not re-match it)
            pending = need.copy()
            for t in range(self.n_tiles):
                for e in (EDGE_W, EDGE_E, EDGE_S, EDGE_N):
                    mask = pending & (tile == t) & (edge_sel == e)
                    if not mask.any():
                        continue
                    if (t, e) not in self.adjacency:
                        raise ValueError(f"tile {t} edge {EDGE_NAMES[e]} has no neighbor")
                    rel = self.adjacency[(t, e)]
                    A, b = self.edge_affine(t, e, n)
                    ym = y[mask]
                    xm = x[mask]
                    y[mask] = A[0, 0] * ym + A[0, 1] * xm + b[0]
                    x[mask] = A[1, 0] * ym + A[1, 1] * xm + b[1]
                    tile[mask] = rel.neighbor_tile
                    A_acc[mask] = np.einsum("ij,...jk->...ik", A, A_acc[mask])
                    pending[mask] = False
        valid = (
            (x >= -eps) & (x <= n + eps) & (y >= -eps) & (y <= n + eps)
        )
        return tile, y, x, A_acc, valid


def _derive_cubed_sphere_adjacency() -> Dict[Tuple[int, int], EdgeRelation]:
    """Numerically derive the 24 edge relations from the face frames."""
    frames = cube_face_frames()
    samples = {}
    for t in range(6):
        for e in (EDGE_W, EDGE_E, EDGE_S, EDGE_N):
            pts = []
            for s in (0.25, 0.75):
                mid = _MID[e].copy()
                tau = _TANGENT[e]
                q = mid + (s - 0.5) * tau  # unit coords on the edge
                pts.append(cube_surface_point(t, q[0], q[1], n=1.0))
            samples[(t, e)] = np.array(pts)
    adjacency: Dict[Tuple[int, int], EdgeRelation] = {}
    for (t, e), pts in samples.items():
        found = None
        for (t2, e2), pts2 in samples.items():
            if t2 == t:
                continue
            if np.allclose(pts, pts2, atol=1e-12):
                found = EdgeRelation(t2, e2, flip=False)
            elif np.allclose(pts, pts2[::-1], atol=1e-12):
                found = EdgeRelation(t2, e2, flip=True)
            if found is not None:
                break
        if found is None:
            raise RuntimeError(f"no neighbor found for tile {t} edge {EDGE_NAMES[e]}")
        adjacency[(t, e)] = found
    # symmetry check: relations come in consistent pairs
    for (t, e), rel in adjacency.items():
        back = adjacency[(rel.neighbor_tile, rel.neighbor_edge)]
        assert back.neighbor_tile == t and back.neighbor_edge == e
        assert back.flip == rel.flip
    return adjacency


_CUBED_SPHERE: Optional[Topology] = None
_DOUBLY_PERIODIC: Optional[Topology] = None


def cubed_sphere_topology() -> Topology:
    global _CUBED_SPHERE
    if _CUBED_SPHERE is None:
        _CUBED_SPHERE = Topology(_derive_cubed_sphere_adjacency(), n_tiles=6)
    return _CUBED_SPHERE


def doubly_periodic_topology() -> Topology:
    """Single periodic tile (reference grid_type=4 Cartesian analog)."""
    global _DOUBLY_PERIODIC
    if _DOUBLY_PERIODIC is None:
        adjacency = {
            (0, EDGE_W): EdgeRelation(0, EDGE_E, flip=False),
            (0, EDGE_E): EdgeRelation(0, EDGE_W, flip=False),
            (0, EDGE_S): EdgeRelation(0, EDGE_N, flip=False),
            (0, EDGE_N): EdgeRelation(0, EDGE_S, flip=False),
        }
        _DOUBLY_PERIODIC = Topology(adjacency, n_tiles=1)
    return _DOUBLY_PERIODIC
