"""Spherical geometry helpers for cubed-sphere grid generation.

Analog of ``ndsl.grid.gnomonic`` (reference usage:
driver/examples/notebooks/functions.py:28 ``great_circle_distance_lon_lat``).
All functions are host-side numpy (grid generation is init-time, float64).

The chart mapping is the *equiangular* gnomonic projection (a TPU-first design
choice: smooth analytic mapping, no iterative edge equalization; the reference's
NDSL uses the equal-edge variant — the discretizations are equivalent-order).
"""

from __future__ import annotations

import numpy as np

from ..constants import PI, RADIUS
from ..parallel.topology import cube_face_frames


def chart_to_sphere(tile, y, x, n: int) -> np.ndarray:
    """Map chart coords (cell units, [0, n]) on ``tile`` to unit-sphere xyz.

    Equiangular gnomonic: chart coordinate maps to an angle in [-π/4, π/4],
    whose tangent gives the cube-face coordinate.
    """
    u, v, nrm = cube_face_frames()[tile]
    xi = (2.0 * np.asarray(x, dtype=np.float64) / n - 1.0) * (PI / 4.0)
    eta = (2.0 * np.asarray(y, dtype=np.float64) / n - 1.0) * (PI / 4.0)
    a = np.tan(xi)
    b = np.tan(eta)
    p = nrm + a[..., None] * u + b[..., None] * v
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def xyz_to_lon_lat(p: np.ndarray):
    """Unit xyz -> (lon, lat) in radians, lon in [0, 2π)."""
    lon = np.arctan2(p[..., 1], p[..., 0]) % (2.0 * PI)
    lat = np.arcsin(np.clip(p[..., 2], -1.0, 1.0))
    return lon, lat


def lon_lat_to_xyz(lon, lat) -> np.ndarray:
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    return np.stack(
        [
            np.cos(lat) * np.cos(lon),
            np.cos(lat) * np.sin(lon),
            np.sin(lat),
        ],
        axis=-1,
    )


def great_circle_distance_xyz(p1, p2, radius: float = RADIUS):
    """Great-circle distance between unit vectors (numerically stable)."""
    cross = np.linalg.norm(np.cross(p1, p2), axis=-1)
    dot = np.sum(p1 * p2, axis=-1)
    return radius * np.arctan2(cross, dot)


def great_circle_distance_lon_lat(lon1, lat1, lon2, lat2, radius: float = RADIUS):
    """Reference-API-compatible distance from lon/lat pairs (radians)."""
    return great_circle_distance_xyz(
        lon_lat_to_xyz(lon1, lat1), lon_lat_to_xyz(lon2, lat2), radius
    )


def spherical_triangle_area(p1, p2, p3, radius: float = 1.0):
    """Area of the spherical triangle with unit-vector vertices (L'Huilier)."""
    a = np.arctan2(np.linalg.norm(np.cross(p2, p3), axis=-1), np.sum(p2 * p3, axis=-1))
    b = np.arctan2(np.linalg.norm(np.cross(p1, p3), axis=-1), np.sum(p1 * p3, axis=-1))
    c = np.arctan2(np.linalg.norm(np.cross(p1, p2), axis=-1), np.sum(p1 * p2, axis=-1))
    s = 0.5 * (a + b + c)
    t = (
        np.tan(0.5 * s)
        * np.tan(0.5 * (s - a))
        * np.tan(0.5 * (s - b))
        * np.tan(0.5 * (s - c))
    )
    return 4.0 * np.arctan(np.sqrt(np.maximum(t, 0.0))) * radius**2


def spherical_quad_area(p1, p2, p3, p4, radius: float = 1.0):
    """Area of a spherical quadrilateral given vertices in cyclic order."""
    return spherical_triangle_area(p1, p2, p3, radius) + spherical_triangle_area(
        p1, p3, p4, radius
    )


def schmidt_transform(xyz, stretch_factor: float, lon_target: float, lat_target: float):
    """Schmidt (1977) grid stretching toward (lon_target, lat_target), radians.

    Analog of the reference's ``direct_transform`` (driver/pace/driver/
    grid.py:288-319). stretch_factor > 1 concentrates resolution near the
    target point.
    """
    c = float(stretch_factor)
    d = (c * c - 1.0) / (c * c + 1.0)
    target = lon_lat_to_xyz(lon_target, lat_target)
    # rotation taking the target to the north pole
    zhat = np.array([0.0, 0.0, 1.0])
    axis = np.cross(target, zhat)
    norm = np.linalg.norm(axis)
    if norm < 1e-14:
        R = np.eye(3) if target[2] > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        axis = axis / norm
        angle = np.arccos(np.clip(np.dot(target, zhat), -1.0, 1.0))
        K = np.array(
            [
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0],
            ]
        )
        R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    p = xyz @ R.T  # target now at north pole
    sinlat = np.clip(p[..., 2], -1.0, 1.0)
    new_sinlat = (d + sinlat) / (1.0 + d * sinlat)
    # scale the horizontal components to keep unit norm
    horiz = np.sqrt(np.maximum(1.0 - new_sinlat**2, 0.0))
    old_horiz = np.sqrt(np.maximum(1.0 - sinlat**2, 1e-30))
    q = np.empty_like(p)
    q[..., 0] = p[..., 0] * horiz / old_horiz
    q[..., 1] = p[..., 1] * horiz / old_horiz
    q[..., 2] = new_sinlat
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q @ R  # rotate back
