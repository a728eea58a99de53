"""Pluggable grid construction.

Port of ``pace_tpu.driver.grid`` (reference role: ``GridInitializerSelector``
with ``GeneratedGridConfig``: stretch_factor, lon_target, lat_target,
grid_type, dx_const, dy_const, deglat, eta_file). ``type: generated``
builds the gnomonic (optionally Schmidt-stretched) cube; ``type: external``
reads FRE-NCtools supergrid tiles through ``MetricTerms.from_external``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..grid.generation import GridSpec, MetricTerms


@dataclasses.dataclass(frozen=True)
class GeneratedGridConfig:
    stretch_factor: Optional[float] = None
    lon_target: Optional[float] = None
    lat_target: Optional[float] = None
    grid_type: int = 0
    dx_const: float = 1000.0
    dy_const: float = 1000.0
    deglat: float = 15.0
    eta_file: Optional[str] = None
    #: FRE-NCtools supergrid tile files for type="external": a format string
    #: with {tile} (1..6)
    tile_paths: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """``{type: generated, config: {...}}`` selector."""

    type: str = "generated"
    config: GeneratedGridConfig = dataclasses.field(
        default_factory=GeneratedGridConfig
    )

    def get_metric_terms(
        self, nx_tile: int, nz: int, layout: Tuple[int, int]
    ) -> MetricTerms:
        if self.type not in ("generated", "external"):
            raise NotImplementedError(
                f"grid source {self.type!r} not implemented "
                "(choose 'generated' or 'external')"
            )
        c = self.config
        spec = GridSpec(
            n_tile=nx_tile,
            npz=nz,
            layout=tuple(layout),
            grid_type=c.grid_type,
            stretch_factor=c.stretch_factor,
            lon_target=c.lon_target,
            lat_target=c.lat_target,
            dx_const=c.dx_const,
            dy_const=c.dy_const,
            deglat=c.deglat,
        )
        if self.type == "external":
            if c.tile_paths is None:
                raise ValueError("external grid requires tile_paths")
            return MetricTerms.from_external(
                c.tile_paths, spec, eta_file=c.eta_file
            )
        return MetricTerms.generate(spec, eta_file=c.eta_file)
