"""Rank-layout math for tiles and the cubed sphere.

API mirrors the reference's ``ndsl.comm.partitioner`` (``TilePartitioner(layout)``,
``CubedSpherePartitioner(tile)``; usage cited at driver/pace/driver/driver.py:716-723,
driver/pace/driver/grid.py:240-260 and docs/util/communication.rst), with internals
re-designed: boundary/rotation information lives in :mod:`pace_tpu.parallel.topology`
and in precomputed gather tables, not in per-rank Boundary objects.

A "rank" here is a logical shard index — on TPU, shards map to mesh coordinates
(tile, y, x), not MPI processes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from .. import constants


@dataclasses.dataclass(frozen=True)
class TilePartitioner:
    """Decomposition of one tile into ``layout=(y_ranks, x_ranks)`` subtiles."""

    layout: Tuple[int, int]

    @property
    def total_ranks(self) -> int:
        return self.layout[0] * self.layout[1]

    def subtile_index(self, rank: int) -> Tuple[int, int]:
        """(y, x) position of this rank within the tile."""
        r = rank % self.total_ranks
        return (r // self.layout[1], r % self.layout[1])

    def subtile_extent(self, tile_extent_y: int, tile_extent_x: int) -> Tuple[int, int]:
        if tile_extent_y % self.layout[0] or tile_extent_x % self.layout[1]:
            raise ValueError(
                f"tile extent ({tile_extent_y}, {tile_extent_x}) not divisible "
                f"by layout {self.layout}"
            )
        return (tile_extent_y // self.layout[0], tile_extent_x // self.layout[1])

    def on_tile_bottom(self, rank: int) -> bool:
        return self.subtile_index(rank)[0] == 0

    def on_tile_top(self, rank: int) -> bool:
        return self.subtile_index(rank)[0] == self.layout[0] - 1

    def on_tile_left(self, rank: int) -> bool:
        return self.subtile_index(rank)[1] == 0

    def on_tile_right(self, rank: int) -> bool:
        return self.subtile_index(rank)[1] == self.layout[1] - 1

    def subtile_slice(
        self,
        rank: int,
        global_dims: Sequence[str],
        global_extent: Sequence[int],
        overlap: bool = False,
    ) -> Tuple[slice, ...]:
        """Slice of the tile-level compute domain owned by ``rank``.

        For interface dims, the extra point is included by the last rank along
        the axis, or by every rank when ``overlap=True`` (reference semantics,
        docs/util/communication.rst Partitioner section).
        """
        py, px = self.subtile_index(rank)
        slices = []
        for dim, extent in zip(global_dims, global_extent):
            if dim in (constants.Y_DIM, constants.Y_INTERFACE_DIM):
                n_ranks, idx = self.layout[0], py
            elif dim in (constants.X_DIM, constants.X_INTERFACE_DIM):
                n_ranks, idx = self.layout[1], px
            else:
                slices.append(slice(0, extent))
                continue
            interface = dim in (constants.X_INTERFACE_DIM, constants.Y_INTERFACE_DIM)
            base = extent - 1 if interface else extent
            if base % n_ranks:
                raise ValueError(
                    f"extent {extent} of {dim} not divisible by {n_ranks} ranks"
                )
            size = base // n_ranks
            start = idx * size
            stop = start + size
            if interface and (overlap or idx == n_ranks - 1):
                stop += 1
            slices.append(slice(start, stop))
        return tuple(slices)


@dataclasses.dataclass(frozen=True)
class CubedSpherePartitioner:
    """6 tiles × a TilePartitioner; rank = tile * ranks_per_tile + tile_rank."""

    tile: TilePartitioner

    @property
    def layout(self) -> Tuple[int, int]:
        return self.tile.layout

    @property
    def total_ranks(self) -> int:
        return constants.N_TILES * self.tile.total_ranks

    def tile_index(self, rank: int) -> int:
        return rank // self.tile.total_ranks

    def tile_root_rank(self, rank: int) -> int:
        return self.tile_index(rank) * self.tile.total_ranks

    def tile_rank(self, rank: int) -> int:
        return rank % self.tile.total_ranks

    def subtile_index(self, rank: int) -> Tuple[int, int]:
        return self.tile.subtile_index(self.tile_rank(rank))

    def rank_of(self, tile: int, py: int, px: int) -> int:
        return tile * self.tile.total_ranks + py * self.layout[1] + px

    @classmethod
    def from_layout(cls, layout: Sequence[int]) -> "CubedSpherePartitioner":
        return cls(TilePartitioner(tuple(layout)))
