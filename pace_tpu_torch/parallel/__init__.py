"""Cube topology, shard layout and halo exchange on stacked shard tensors."""

from .gather import gather_tiles, scatter_tiles
from .halo import HaloExchanger
from .partitioner import CubedSpherePartitioner, TilePartitioner
from .topology import (
    EDGE_E,
    EDGE_N,
    EDGE_S,
    EDGE_W,
    EdgeRelation,
    Topology,
    cube_face_frames,
    cube_surface_point,
    cubed_sphere_topology,
    doubly_periodic_topology,
)

__all__ = [
    "Topology",
    "EdgeRelation",
    "cubed_sphere_topology",
    "doubly_periodic_topology",
    "cube_surface_point",
    "cube_face_frames",
    "TilePartitioner",
    "CubedSpherePartitioner",
    "HaloExchanger",
    "gather_tiles",
    "scatter_tiles",
    "EDGE_W",
    "EDGE_E",
    "EDGE_S",
    "EDGE_N",
]
