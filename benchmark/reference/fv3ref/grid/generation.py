"""Cubed-sphere metric terms, generated from a fold-resolved supergrid.

Port of ``pace_tpu.grid.generation`` (numpy, float64, host-side). Analog of
NDSL's ``MetricTerms`` (reference API at
driver/pace/driver/grid.py:11-27,104-142; full field inventory at reference
tests/mpi_54rank/test_grid_init.py:33-121). Re-design:

- All geometry is evaluated host-side (numpy, float64) at init; results are
  stacked per-shard arrays ``(S, [9|3,] Y, X)`` matching the halo layout of
  :mod:`pace_tpu_torch.parallel.halo`; :class:`~pace_tpu_torch.grid.grid_data.GridData`
  moves them to the device.
- Each shard's *supergrid* (corner+midpoint+center positions at half-cell
  spacing, including the halo) is resolved through the cube topology, so ghost
  metric values are exact physical values of the neighboring tile — no
  mirror-grid or special-case edge fills.
- Discrete local bases (half-cell centered differences of supergrid positions)
  define grid angles (cos_sg/sin_sg analogs) and unit vectors (ec/ew/es).

Supergrid-angle index convention (this framework's own; FV3's sin_sg1..9 maps
onto it as W,S,E,N→1,2,3,4 etc.):
``SG_CENTER=0, SG_W=1, SG_E=2, SG_S=3, SG_N=4, SG_SW=5, SG_SE=6, SG_NW=7,
SG_NE=8``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .. import constants
from ..constants import OMEGA, RADIUS
from ..parallel.halo import HaloExchanger
from ..parallel.partitioner import CubedSpherePartitioner, TilePartitioner
from ..parallel.topology import (
    Topology,
    cubed_sphere_topology,
    doubly_periodic_topology,
)
from . import eta as eta_mod
from .gnomonic import (
    chart_to_sphere,
    great_circle_distance_xyz,
    schmidt_transform,
    spherical_quad_area,
    xyz_to_lon_lat,
)

SG_CENTER, SG_W, SG_E, SG_S, SG_N, SG_SW, SG_SE, SG_NW, SG_NE = range(9)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of one decomposition."""

    n_tile: int  # cells per tile side (e.g. 192 for C192)
    npz: int
    layout: Tuple[int, int]
    n_halo: int = constants.N_HALO_DEFAULT
    grid_type: int = 0  # 0 = gnomonic cubed sphere, 4 = doubly-periodic plane
    stretch_factor: Optional[float] = None
    lon_target: Optional[float] = None  # degrees
    lat_target: Optional[float] = None  # degrees
    dx_const: float = 1000.0  # grid_type=4 only [m]
    dy_const: float = 1000.0
    deglat: float = 15.0

    @property
    def n_tiles(self) -> int:
        return 1 if self.grid_type == 4 else constants.N_TILES

    @property
    def shards(self) -> int:
        return self.n_tiles * self.layout[0] * self.layout[1]


@dataclasses.dataclass
class MetricTerms:
    """All horizontal metric fields (stacked per-shard, halo-inclusive) + ak/bk.

    Shapes use Y = nsy + 2h, X = nsx + 2h; staggered fields get +1.
    """

    spec: GridSpec
    topology: Topology
    partitioner: CubedSpherePartitioner
    halo: HaloExchanger

    # positions
    lon: np.ndarray  # (S, Y+1, X+1) corner longitudes [rad]
    lat: np.ndarray
    lon_agrid: np.ndarray  # (S, Y, X)
    lat_agrid: np.ndarray
    xyz_corner: np.ndarray  # (S, Y+1, X+1, 3) unit vectors
    xyz_center: np.ndarray  # (S, Y, X, 3)
    xyz_u: np.ndarray  # (S, Y+1, X, 3) y-interface (D-grid u) points
    xyz_v: np.ndarray  # (S, Y, X+1, 3) x-interface (D-grid v / C-grid u) points

    # lengths [m]
    dx: np.ndarray  # (S, Y+1, X)  cell south/north edge lengths (u-point rows)
    dy: np.ndarray  # (S, Y, X+1)
    dxa: np.ndarray  # (S, Y, X)
    dya: np.ndarray
    dxc: np.ndarray  # (S, Y, X+1)
    dyc: np.ndarray  # (S, Y+1, X)

    # areas [m^2]
    area: np.ndarray  # (S, Y, X)
    area_c: np.ndarray  # (S, Y+1, X+1)

    # angles
    cos_sg: np.ndarray  # (S, 9, Y, X)
    sin_sg: np.ndarray  # (S, 9, Y, X)
    cosa: np.ndarray  # (S, Y+1, X+1) at corners
    sina: np.ndarray
    cosa_u: np.ndarray  # (S, Y+1, X) at u points
    sina_u: np.ndarray
    cosa_v: np.ndarray  # (S, Y, X+1) at v points
    sina_v: np.ndarray
    cosa_s: np.ndarray  # (S, Y, X) at centers
    rsin2: np.ndarray  # 1/sin^2 at centers

    # unit local bases (x-direction, y-direction) at staggered points
    ec1: np.ndarray  # (S, Y, X, 3) x-basis at centers
    ec2: np.ndarray  # y-basis at centers
    ew1: np.ndarray  # (S, Y, X+1, 3) at v/x-interface points
    ew2: np.ndarray
    es1: np.ndarray  # (S, Y+1, X, 3) at u/y-interface points
    es2: np.ndarray

    # east/north unit vectors for wind conversion at staggered points
    elon_u: np.ndarray  # (S, Y+1, X, 3)
    elat_u: np.ndarray
    elon_v: np.ndarray  # (S, Y, X+1, 3)
    elat_v: np.ndarray
    elon_a: np.ndarray  # (S, Y, X, 3)
    elat_a: np.ndarray

    # Coriolis
    f0: np.ndarray  # (S, Y, X) at centers
    fC: np.ndarray  # (S, Y+1, X+1) at corners

    # vertical coordinate
    ak: np.ndarray  # (npz+1,)
    bk: np.ndarray

    radius: float = RADIUS

    @property
    def ptop(self) -> float:
        return float(self.ak[0])

    # reciprocals (computed lazily, cached)
    def __post_init__(self):
        self.rarea = 1.0 / self.area
        self.rarea_c = 1.0 / self.area_c
        self.rdx = 1.0 / self.dx
        self.rdy = 1.0 / self.dy
        self.rdxa = 1.0 / self.dxa
        self.rdya = 1.0 / self.dya
        self.rdxc = 1.0 / self.dxc
        self.rdyc = 1.0 / self.dyc
        self.rsina = 1.0 / np.maximum(self.sina, 1e-4)
        self.rsin_u = 1.0 / np.maximum(self.sina_u, 1e-4)
        self.rsin_v = 1.0 / np.maximum(self.sina_v, 1e-4)

    @classmethod
    def generate(
        cls,
        spec: GridSpec,
        eta_file: Optional[str] = None,
        radius: float = RADIUS,
    ) -> "MetricTerms":
        if spec.grid_type == 4:
            return _generate_doubly_periodic(cls, spec, eta_file)
        return _generate_cubed_sphere(cls, spec, eta_file, radius)

    @classmethod
    def from_external(
        cls,
        tile_paths,
        spec: GridSpec,
        eta_file: Optional[str] = None,
        radius: float = RADIUS,
    ) -> "MetricTerms":
        """Build metric terms from FRE-NCtools supergrid tile files (reference
        ``MetricTerms.from_external`` / ExternalNetcdfGridConfig). ``tile_paths``
        is a list of six NetCDF-3 files with variables ``x``/``y`` — supergrid
        longitudes/latitudes in degrees, shape (2n+1, 2n+1) — or a format
        string with ``{tile}`` resolving to those paths (tiles numbered
        1..6)."""
        from ..utils import netcdf3

        if isinstance(tile_paths, str):
            tile_paths = [tile_paths.format(tile=t + 1) for t in range(6)]
        tiles = []
        for p in tile_paths:
            f = netcdf3.read(p)
            x = np.asarray(f.variables["x"].data, dtype=np.float64)
            y = np.asarray(f.variables["y"].data, dtype=np.float64)
            exp = 2 * spec.n_tile + 1
            if x.shape != (exp, exp):
                raise ValueError(
                    f"{p}: supergrid shape {x.shape} != expected ({exp},{exp})"
                )
            lon = np.deg2rad(x)
            lat = np.deg2rad(y)
            tiles.append(
                np.stack(
                    [
                        np.cos(lat) * np.cos(lon),
                        np.cos(lat) * np.sin(lon),
                        np.sin(lat),
                    ],
                    axis=-1,
                )
            )
        ext = np.stack(tiles)  # (6, 2n+1, 2n+1, 3)
        return _generate_cubed_sphere(
            cls, spec, eta_file, radius, external_supergrid=ext
        )


def _positions_for(topology, tile, y, x, n, schmidt_params):
    """Resolve chart points through the topology and project to the sphere."""
    t2, y2, x2, _A, valid = topology.resolve_points(tile, y, x, n, corner_fold="x")
    assert valid.all()
    pos = np.empty(t2.shape + (3,), dtype=np.float64)
    for t in range(topology.n_tiles):
        m = t2 == t
        if m.any():
            pos[m] = chart_to_sphere(t, y2[m], x2[m], n)
    if schmidt_params is not None:
        c, lon_t, lat_t = schmidt_params
        pos = schmidt_transform(pos, c, lon_t, lat_t)
    return pos


def _generate_cubed_sphere(
    cls, spec: GridSpec, eta_file, radius, external_supergrid=None
) -> "MetricTerms":
    topo = cubed_sphere_topology()
    part = CubedSpherePartitioner(TilePartitioner(spec.layout))
    halo = HaloExchanger(topo, part, spec.n_tile, spec.n_halo)
    h = spec.n_halo
    nsy, nsx = halo.nsy, halo.nsx
    Ys, Xs = nsy + 2 * h, nsx + 2 * h
    n = spec.n_tile
    S = halo.n_shards

    schmidt_params = None
    if spec.stretch_factor is not None and spec.stretch_factor != 1.0:
        schmidt_params = (
            spec.stretch_factor,
            np.deg2rad(spec.lon_target if spec.lon_target is not None else 0.0),
            np.deg2rad(spec.lat_target if spec.lat_target is not None else 0.0),
        )

    # --- supergrid positions per shard: (S, 2Ys+1, 2Xs+1, 3)
    r = np.arange(2 * Ys + 1)
    c = np.arange(2 * Xs + 1)
    rr, cc = np.meshgrid(r, c, indexing="ij")
    sg = np.empty((S, 2 * Ys + 1, 2 * Xs + 1, 3), dtype=np.float64)
    for s in range(S):
        t, py, px = halo._shard_info(s)
        gy = py * nsy + (rr / 2.0 - h)
        gx = px * nsx + (cc / 2.0 - h)
        if external_supergrid is None:
            sg[s] = _positions_for(
                topo, np.full(rr.shape, t), gy, gx, n, schmidt_params
            )
        else:
            # external grid: resolve chart coordinates through the topology,
            # then LOOK UP the neighbor tiles' supergrid points (halo points
            # land exactly on neighbor supergrid nodes)
            t2, y2, x2, _A, valid = topo.resolve_points(
                np.full(rr.shape, t), gy, gx, n, corner_fold="x"
            )
            assert valid.all()
            iy = np.clip(np.rint(2.0 * y2).astype(np.int64), 0, 2 * n)
            ix = np.clip(np.rint(2.0 * x2).astype(np.int64), 0, 2 * n)
            sg[s] = external_supergrid[t2, iy, ix]

    # views
    P_corner = sg[:, 0::2, 0::2]  # (S, Ys+1, Xs+1, 3)
    P_center = sg[:, 1::2, 1::2]  # (S, Ys, Xs, 3)
    P_u = sg[:, 0::2, 1::2]  # y-interface points (S, Ys+1, Xs, 3)
    P_v = sg[:, 1::2, 0::2]  # x-interface points (S, Ys, Xs+1, 3)

    lon_c, lat_c = xyz_to_lon_lat(P_corner)
    lon_a, lat_a = xyz_to_lon_lat(P_center)

    dist = lambda p, q: great_circle_distance_xyz(p, q, radius)  # noqa: E731
    dx = dist(P_corner[:, :, :-1], P_corner[:, :, 1:])  # (S, Ys+1, Xs)
    dy = dist(P_corner[:, :-1, :], P_corner[:, 1:, :])  # (S, Ys, Xs+1)
    dxa = dist(P_v[:, :, :-1], P_v[:, :, 1:])  # (S, Ys, Xs)
    dya = dist(P_u[:, :-1, :], P_u[:, 1:, :])  # (S, Ys, Xs)
    # dxc at v points from adjacent centers; replicate at array boundary
    dxc = np.empty((S, Ys, Xs + 1))
    dxc[:, :, 1:-1] = dist(P_center[:, :, :-1], P_center[:, :, 1:])
    dxc[:, :, 0] = dxc[:, :, 1]
    dxc[:, :, -1] = dxc[:, :, -2]
    dyc = np.empty((S, Ys + 1, Xs))
    dyc[:, 1:-1, :] = dist(P_center[:, :-1, :], P_center[:, 1:, :])
    dyc[:, 0, :] = dyc[:, 1, :]
    dyc[:, -1, :] = dyc[:, -2, :]

    # Cube-corner fold degeneracy: distinct chart ghost points can resolve to
    # the same physical cell (the fold wraps 270° of physical angle), making a
    # few corner-region ghost lengths zero. Those values are never meaningful
    # (the reference fills them with big_number); replace with the median so
    # reciprocals stay finite.
    def _sanitize(arr):
        med = np.median(arr)
        return np.where(arr < 1e-3 * med, med, arr)

    dx, dy, dxa, dya, dxc, dyc = (
        _sanitize(a) for a in (dx, dy, dxa, dya, dxc, dyc)
    )

    area = spherical_quad_area(
        P_corner[:, :-1, :-1],
        P_corner[:, :-1, 1:],
        P_corner[:, 1:, 1:],
        P_corner[:, 1:, :-1],
        radius,
    )

    # --- area_c: dual areas via quadrant quarter-quads around each corner
    area_c = np.zeros((S, Ys + 1, Xs + 1))
    quarter = {}
    # quarter-quad areas per cell, adjacent to each of the 4 cell corners
    # around cell (j, i): corner, edge-mid, center, edge-mid
    quarter["ne_of_corner"] = spherical_quad_area(  # cell is NE of its SW corner
        P_corner[:, :-1, :-1], P_u[:, :-1, :], P_center, P_v[:, :, :-1], radius
    )
    quarter["nw_of_corner"] = spherical_quad_area(  # cell NW of its SE corner
        P_corner[:, :-1, 1:], P_u[:, :-1, :], P_center, P_v[:, :, 1:], radius
    )
    quarter["se_of_corner"] = spherical_quad_area(  # cell SE of its NW corner
        P_corner[:, 1:, :-1], P_u[:, 1:, :], P_center, P_v[:, :, :-1], radius
    )
    quarter["sw_of_corner"] = spherical_quad_area(  # cell SW of its NE corner
        P_corner[:, 1:, 1:], P_u[:, 1:, :], P_center, P_v[:, :, 1:], radius
    )
    # accumulate onto corners; cube-corner points get only their 3 valid quadrants
    area_c[:, :-1, :-1] += quarter["ne_of_corner"]
    area_c[:, :-1, 1:] += quarter["nw_of_corner"]
    area_c[:, 1:, :-1] += quarter["se_of_corner"]
    area_c[:, 1:, 1:] += quarter["sw_of_corner"]
    # subtract the folded (nonexistent) quadrant at the 8 cube corners:
    # tile corners are at global chart coords in {0, n}²
    for s in range(S):
        t, py, px = halo._shard_info(s)
        for (gy, gx) in [(0, 0), (0, n), (n, 0), (n, n)]:
            jj = gy - py * nsy + h
            ii = gx - px * nsx + h
            if 0 <= jj <= Ys and 0 <= ii <= Xs:
                # outward diagonal quadrant relative to the tile
                if gy == 0 and gx == 0:
                    q = quarter["sw_of_corner"][s, jj - 1, ii - 1] if jj > 0 and ii > 0 else 0.0
                elif gy == 0:
                    q = quarter["se_of_corner"][s, jj - 1, ii] if jj > 0 and ii < Xs else 0.0
                elif gx == 0:
                    q = quarter["nw_of_corner"][s, jj, ii - 1] if jj < Ys and ii > 0 else 0.0
                else:
                    q = quarter["ne_of_corner"][s, jj, ii] if jj < Ys and ii < Xs else 0.0
                area_c[s, jj, ii] -= q

    area = _sanitize(area)
    # The outermost ghost ring of corners only accumulates the quadrants of
    # cells inside the array (the cells beyond the halo don't exist here), so
    # its dual areas come out ~half-sized. Those values feed the outer ring of
    # the del-n damping Laplacian iterations — a half-sized area there doubles
    # the local eigenvalue and tips the nord=3 damping into an overdamping
    # instability at tile edges. Replace the ring by linear extrapolation from
    # the two adjacent rings (smooth metric, O(h^2) accurate).
    area_c[:, 0, :] = 2.0 * area_c[:, 1, :] - area_c[:, 2, :]
    area_c[:, -1, :] = 2.0 * area_c[:, -2, :] - area_c[:, -3, :]
    area_c[:, :, 0] = 2.0 * area_c[:, :, 1] - area_c[:, :, 2]
    area_c[:, :, -1] = 2.0 * area_c[:, :, -2] - area_c[:, :, -3]
    area_c = _sanitize(area_c)

    # --- local bases at all supergrid points (centered differences)
    def _basis(sgrid, axis):
        d = np.empty_like(sgrid)
        if axis == 1:  # y-direction (rows)
            d[:, 1:-1] = sgrid[:, 2:] - sgrid[:, :-2]
            d[:, 0] = sgrid[:, 1] - sgrid[:, 0]
            d[:, -1] = sgrid[:, -1] - sgrid[:, -2]
        else:  # x-direction (cols)
            d[:, :, 1:-1] = sgrid[:, :, 2:] - sgrid[:, :, :-2]
            d[:, :, 0] = sgrid[:, :, 1] - sgrid[:, :, 0]
            d[:, :, -1] = sgrid[:, :, -1] - sgrid[:, :, -2]
        # project onto the tangent plane (remove radial component) & normalize
        radial = np.sum(d * sgrid, axis=-1, keepdims=True)
        d = d - radial * sgrid
        return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)

    ex_sg = _basis(sg, axis=2)
    ey_sg = _basis(sg, axis=1)
    cos_full = np.sum(ex_sg * ey_sg, axis=-1)
    sin_full = np.sqrt(np.maximum(1.0 - cos_full**2, 1e-8))

    # angles at the 9 cell positions: (S, 9, Ys, Xs)
    cos_sg = np.stack(
        [
            cos_full[:, 1::2, 1::2],  # center
            cos_full[:, 1::2, 0:-1:2],  # W
            cos_full[:, 1::2, 2::2],  # E
            cos_full[:, 0:-1:2, 1::2],  # S
            cos_full[:, 2::2, 1::2],  # N
            cos_full[:, 0:-1:2, 0:-1:2],  # SW
            cos_full[:, 0:-1:2, 2::2],  # SE
            cos_full[:, 2::2, 0:-1:2],  # NW
            cos_full[:, 2::2, 2::2],  # NE
        ],
        axis=1,
    )
    sin_sg = np.sqrt(np.maximum(1.0 - cos_sg**2, 1e-8))

    cosa = cos_full[:, 0::2, 0::2]
    sina = sin_full[:, 0::2, 0::2]
    cosa_u = cos_full[:, 0::2, 1::2]
    sina_u = sin_full[:, 0::2, 1::2]
    cosa_v = cos_full[:, 1::2, 0::2]
    sina_v = sin_full[:, 1::2, 0::2]
    cosa_s = cos_full[:, 1::2, 1::2]
    rsin2 = 1.0 / np.maximum(sin_full[:, 1::2, 1::2] ** 2, 1e-8)

    ec1 = ex_sg[:, 1::2, 1::2]
    ec2 = ey_sg[:, 1::2, 1::2]
    ew1 = ex_sg[:, 1::2, 0::2]
    ew2 = ey_sg[:, 1::2, 0::2]
    es1 = ex_sg[:, 0::2, 1::2]
    es2 = ey_sg[:, 0::2, 1::2]

    # east/north unit vectors
    def _east_north(P):
        lon, lat = xyz_to_lon_lat(P)
        east = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], axis=-1)
        north = np.stack(
            [
                -np.sin(lat) * np.cos(lon),
                -np.sin(lat) * np.sin(lon),
                np.cos(lat),
            ],
            axis=-1,
        )
        return east, north

    elon_u, elat_u = _east_north(P_u)
    elon_v, elat_v = _east_north(P_v)
    elon_a, elat_a = _east_north(P_center)

    f0 = 2.0 * OMEGA * np.sin(lat_a)
    fC = 2.0 * OMEGA * np.sin(lat_c)

    coeffs = eta_mod.get_coefficients(spec.npz, eta_file)

    return cls(
        spec=spec,
        topology=topo,
        partitioner=part,
        halo=halo,
        lon=lon_c,
        lat=lat_c,
        lon_agrid=lon_a,
        lat_agrid=lat_a,
        xyz_corner=P_corner,
        xyz_center=P_center,
        xyz_u=P_u,
        xyz_v=P_v,
        dx=dx,
        dy=dy,
        dxa=dxa,
        dya=dya,
        dxc=dxc,
        dyc=dyc,
        area=area,
        area_c=area_c,
        cos_sg=cos_sg,
        sin_sg=sin_sg,
        cosa=cosa,
        sina=sina,
        cosa_u=cosa_u,
        sina_u=sina_u,
        cosa_v=cosa_v,
        sina_v=sina_v,
        cosa_s=cosa_s,
        rsin2=rsin2,
        ec1=ec1,
        ec2=ec2,
        ew1=ew1,
        ew2=ew2,
        es1=es1,
        es2=es2,
        elon_u=elon_u,
        elat_u=elat_u,
        elon_v=elon_v,
        elat_v=elat_v,
        elon_a=elon_a,
        elat_a=elat_a,
        f0=f0,
        fC=fC,
        ak=coeffs.ak,
        bk=coeffs.bk,
        radius=radius,
    )


def _generate_doubly_periodic(cls, spec: GridSpec, eta_file) -> "MetricTerms":
    """Uniform Cartesian plane with periodic wrap (reference grid_type=4,
    ``MetricTerms.from_tile_sizing`` analog; reference
    tests/main/fv3core/test_cartesian_grid.py:30-41)."""
    topo = doubly_periodic_topology()
    part = CubedSpherePartitioner(TilePartitioner(spec.layout))
    # partitioner math assumes 6 tiles; shard indexing here only uses tile 0
    halo = HaloExchanger(topo, part, spec.n_tile, spec.n_halo)
    h = spec.n_halo
    nsy, nsx = halo.nsy, halo.nsx
    Ys, Xs = nsy + 2 * h, nsx + 2 * h
    S = halo.n_shards
    dxc0, dyc0 = spec.dx_const, spec.dy_const

    def full(shape, val):
        return np.full((S,) + shape, val, dtype=np.float64)

    lat0 = np.deg2rad(spec.deglat)
    # pseudo lon/lat for diagnostics: equirectangular local coords
    lon_c = np.zeros((S, Ys + 1, Xs + 1))
    lat_c = np.full((S, Ys + 1, Xs + 1), lat0)
    for s in range(S):
        t, py, px = halo._shard_info(s)
        jj, ii = np.meshgrid(
            py * nsy + np.arange(Ys + 1) - h,
            px * nsx + np.arange(Xs + 1) - h,
            indexing="ij",
        )
        lon_c[s] = ii * dxc0 / RADIUS
        lat_c[s] = lat0 + jj * dyc0 / RADIUS
    lon_a = 0.25 * (
        lon_c[:, :-1, :-1] + lon_c[:, :-1, 1:] + lon_c[:, 1:, :-1] + lon_c[:, 1:, 1:]
    )
    lat_a = 0.25 * (
        lat_c[:, :-1, :-1] + lat_c[:, :-1, 1:] + lat_c[:, 1:, :-1] + lat_c[:, 1:, 1:]
    )

    ex = np.array([1.0, 0.0, 0.0])
    ey = np.array([0.0, 1.0, 0.0])
    coeffs = eta_mod.get_coefficients(spec.npz, eta_file)
    e_x = lambda shape: np.broadcast_to(ex, (S,) + shape + (3,)).copy()  # noqa: E731
    e_y = lambda shape: np.broadcast_to(ey, (S,) + shape + (3,)).copy()  # noqa: E731

    f_const = 2.0 * OMEGA * np.sin(lat0)
    xyz_c = np.zeros((S, Ys + 1, Xs + 1, 3))
    xyz_a = np.zeros((S, Ys, Xs, 3))

    return cls(
        spec=spec,
        topology=topo,
        partitioner=part,
        halo=halo,
        lon=lon_c,
        lat=lat_c,
        lon_agrid=lon_a,
        lat_agrid=lat_a,
        xyz_corner=xyz_c,
        xyz_center=xyz_a,
        xyz_u=np.zeros((S, Ys + 1, Xs, 3)),
        xyz_v=np.zeros((S, Ys, Xs + 1, 3)),
        dx=full((Ys + 1, Xs), dxc0),
        dy=full((Ys, Xs + 1), dyc0),
        dxa=full((Ys, Xs), dxc0),
        dya=full((Ys, Xs), dyc0),
        dxc=full((Ys, Xs + 1), dxc0),
        dyc=full((Ys + 1, Xs), dyc0),
        area=full((Ys, Xs), dxc0 * dyc0),
        area_c=full((Ys + 1, Xs + 1), dxc0 * dyc0),
        cos_sg=full((9, Ys, Xs), 0.0),
        sin_sg=full((9, Ys, Xs), 1.0),
        cosa=full((Ys + 1, Xs + 1), 0.0),
        sina=full((Ys + 1, Xs + 1), 1.0),
        cosa_u=full((Ys + 1, Xs), 0.0),
        sina_u=full((Ys + 1, Xs), 1.0),
        cosa_v=full((Ys, Xs + 1), 0.0),
        sina_v=full((Ys, Xs + 1), 1.0),
        cosa_s=full((Ys, Xs), 0.0),
        rsin2=full((Ys, Xs), 1.0),
        ec1=e_x((Ys, Xs)),
        ec2=e_y((Ys, Xs)),
        ew1=e_x((Ys, Xs + 1)),
        ew2=e_y((Ys, Xs + 1)),
        es1=e_x((Ys + 1, Xs)),
        es2=e_y((Ys + 1, Xs)),
        elon_u=e_x((Ys + 1, Xs)),
        elat_u=e_y((Ys + 1, Xs)),
        elon_v=e_x((Ys, Xs + 1)),
        elat_v=e_y((Ys, Xs + 1)),
        elon_a=e_x((Ys, Xs)),
        elat_a=e_y((Ys, Xs)),
        f0=full((Ys, Xs), f_const),
        fC=full((Ys + 1, Xs + 1), f_const),
        ak=coeffs.ak,
        bk=coeffs.bk,
    )
