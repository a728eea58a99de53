"""Gather and scatter between stacked shards and whole tiles.

Port of ``pace_tpu.parallel.gather`` (reference role: the communicator's
``gather`` of a rank's subtile into the whole tile on the tile root, and
``scatter`` of a tile to its subtiles). Every shard lies on the leading axis
of one array, so both are reassembly on the host: no communication (on a
mesh, ``parallel.mesh.gather_to_root`` first brings the shards to rank 0).

Staggers as in ``parallel/halo.py``: ``center``, ``corner``,
``y_interface`` (D-grid u), ``x_interface`` (D-grid v). An
interface-inclusive axis owns one point more; neighbouring shards hold the
same value on the line they share, so gather may take either copy.
Arrays are numpy arrays or tensors (taken to the host); results are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.ranges import host_sync
from .halo import interface_extents
from .partitioner import CubedSpherePartitioner


def _host(a) -> np.ndarray:
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    with host_sync("gather"):
        return a.detach().cpu().numpy()


def gather_tiles(
    arr,
    partitioner: CubedSpherePartitioner,
    n_halo: int,
    stagger: str = "center",
) -> np.ndarray:
    """``(S, ..., nsy+2h+ey, nsx+2h+ex)`` stacked shards -> ``(6, ...,
    NY+ey, NX+ex)`` whole tiles (interiors only; halos dropped)."""
    arr = _host(arr)
    ly, lx = partitioner.layout
    h = n_halo
    ey, ex = interface_extents(stagger)
    nsy = arr.shape[-2] - 2 * h - ey
    nsx = arr.shape[-1] - 2 * h - ex
    if nsy <= 0 or nsx <= 0:
        raise ValueError(
            f"shard shape {arr.shape[-2:]} too small for n_halo={h} stagger={stagger!r}"
        )
    out = np.zeros(arr.shape[1:-2] + (6, ly * nsy + ey, lx * nsx + ex), dtype=arr.dtype)
    # the tile axis in front of the trailing (y, x)
    out = np.moveaxis(out, -3, 0)
    for t in range(6):
        for py in range(ly):
            for px in range(lx):
                s = partitioner.rank_of(t, py, px)
                out[t, ..., py * nsy:(py + 1) * nsy + ey, px * nsx:(px + 1) * nsx + ex] = \
                    arr[s, ..., h:h + nsy + ey, h:h + nsx + ex]
    return out


def scatter_tiles(
    tiles,
    partitioner: CubedSpherePartitioner,
    n_halo: int,
    stagger: str = "center",
) -> np.ndarray:
    """``(6, ..., NY+ey, NX+ex)`` whole tiles -> ``(S, ..., nsy+2h+ey,
    nsx+2h+ex)`` stacked shards with zero halos (a halo update fills
    them)."""
    tiles = _host(tiles)
    ly, lx = partitioner.layout
    h = n_halo
    ey, ex = interface_extents(stagger)
    if (tiles.shape[-2] - ey) % ly or (tiles.shape[-1] - ex) % lx:
        raise ValueError(
            f"tile extent {tiles.shape[-2:]} (stagger={stagger!r}) not "
            f"evenly divisible by layout {(ly, lx)}"
        )
    nsy = (tiles.shape[-2] - ey) // ly
    nsx = (tiles.shape[-1] - ex) // lx
    S = 6 * ly * lx
    out = np.zeros((S,) + tiles.shape[1:-2] + (nsy + 2 * h + ey, nsx + 2 * h + ex),
                   dtype=tiles.dtype)
    for t in range(6):
        for py in range(ly):
            for px in range(lx):
                s = partitioner.rank_of(t, py, px)
                out[s, ..., h:h + nsy + ey, h:h + nsx + ex] = tiles[
                    t, ..., py * nsy:(py + 1) * nsy + ey, px * nsx:(px + 1) * nsx + ex]
    return out
