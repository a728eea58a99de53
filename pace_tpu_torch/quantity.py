"""Quantity: a dims/units/halo-aware container over a torch tensor.

Port of ``pace_tpu.quantity`` (reference role: ``ndsl.quantity.Quantity``:
``.data`` includes the halo, ``.view`` indexes the compute domain,
``.metadata`` carries dims/units/origin/extent). There is no backend zoo:
the array is a torch tensor on one device (the card unless the caller asks
for the CPU), and the compute functions of :mod:`pace_tpu_torch.ops` take
and return raw tensors; Quantity is the user-facing container for halo and
IO metadata. Updates are functional: ``with_data`` and ``with_view`` return
a new Quantity and never write the old one's tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from . import constants
from .dtypes import check_dtype, resolve_device


@dataclasses.dataclass(frozen=True)
class QuantityMetadata:
    dims: Tuple[str, ...]
    units: str
    origin: Tuple[int, ...]
    extent: Tuple[int, ...]
    dtype: Any

    @property
    def dim_lengths(self) -> Mapping[str, int]:
        return dict(zip(self.dims, self.extent))


class Quantity:
    """A named, unit-tagged tensor with an explicit compute domain.

    Parameters
    ----------
    data:
        tensor including any halo/ghost region.
    dims:
        names for each axis (e.g. ``("tile", "z", "y", "x")``).
    units:
        physical units string (e.g. ``"m/s"``).
    origin:
        index of the first compute-domain point along each axis.
    extent:
        number of compute-domain points along each axis.
    """

    def __init__(
        self,
        data: torch.Tensor,
        dims: Sequence[str],
        units: str,
        origin: Sequence[int] | None = None,
        extent: Sequence[int] | None = None,
    ):
        dims = tuple(dims)
        if origin is None:
            origin = (0,) * len(dims)
        origin = tuple(int(o) for o in origin)
        if extent is None:
            extent = tuple(int(s - o) for s, o in zip(data.shape, origin))
        extent = tuple(int(e) for e in extent)
        if len(dims) != data.ndim:
            raise ValueError(
                f"dims {dims} does not match array of rank {data.ndim}"
            )
        if len(origin) != data.ndim or len(extent) != data.ndim:
            raise ValueError("origin/extent must have one entry per dimension")
        self._data = data
        self._dims = dims
        self._units = units
        self._origin = origin
        self._extent = extent

    # -- reference-parity accessors --------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """Full tensor including halo."""
        return self._data

    @property
    def dims(self) -> Tuple[str, ...]:
        return self._dims

    @property
    def units(self) -> str:
        return self._units

    @property
    def origin(self) -> Tuple[int, ...]:
        return self._origin

    @property
    def extent(self) -> Tuple[int, ...]:
        return self._extent

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def np(self):
        """Backend module (always torch; kept for reference-API familiarity)."""
        return torch

    @property
    def metadata(self) -> QuantityMetadata:
        return QuantityMetadata(
            dims=self._dims,
            units=self._units,
            origin=self._origin,
            extent=self._extent,
            dtype=self._data.dtype,
        )

    def _slices(self):
        return tuple(slice(o, o + e) for o, e in zip(self._origin, self._extent))

    @property
    def view(self) -> torch.Tensor:
        """The compute domain (no halo) as a view of the tensor."""
        return self._data[self._slices()]

    def with_data(self, data: torch.Tensor) -> "Quantity":
        """Same metadata, new tensor (functional update)."""
        if tuple(data.shape) != tuple(self._data.shape):
            raise ValueError(
                f"shape mismatch: {tuple(data.shape)} vs {tuple(self._data.shape)}"
            )
        return Quantity(
            data, self._dims, self._units, self._origin, self._extent
        )

    def with_view(self, interior) -> "Quantity":
        """Functionally replace the compute domain, keeping the halo."""
        data = self._data.clone()
        data[self._slices()] = torch.as_tensor(interior, dtype=data.dtype,
                                               device=data.device)
        return self.with_data(data)

    def transpose(self, target_dims: Sequence[str]) -> "Quantity":
        perm = tuple(self._dims.index(d) for d in target_dims)
        return Quantity(
            self._data.permute(perm),
            tuple(self._dims[p] for p in perm),
            self._units,
            tuple(self._origin[p] for p in perm),
            tuple(self._extent[p] for p in perm),
        )

    def to_numpy(self) -> np.ndarray:
        return self._data.detach().cpu().numpy()

    def __repr__(self):
        return (
            f"Quantity(dims={self._dims}, units={self._units!r}, "
            f"origin={self._origin}, extent={self._extent}, "
            f"shape={tuple(self._data.shape)}, dtype={self._data.dtype})"
        )


def zeros(
    dims: Sequence[str],
    units: str,
    *,
    sizes: Mapping[str, int],
    n_halo: int = constants.N_HALO_DEFAULT,
    device="cuda",
    dtype=torch.float32,
) -> Quantity:
    """Allocate a zeroed Quantity with halos on horizontal dims.

    ``sizes`` maps dim name -> compute extent (non-interface size); interface
    dims automatically get +1. Horizontal dims get ``n_halo`` ghost cells per
    side; tile/z dims get none.
    """
    shape = []
    origin = []
    extent = []
    for d in dims:
        base = d.replace("_interface", "")
        n = sizes[base] + (1 if d.endswith("_interface") else 0)
        halo = n_halo if base in ("x", "y") else 0
        shape.append(n + 2 * halo)
        origin.append(halo)
        extent.append(n)
    data = torch.zeros(tuple(shape), dtype=check_dtype(dtype), device=resolve_device(device))
    return Quantity(data, dims, units, origin, extent)


@dataclasses.dataclass(frozen=True)
class SubtileGridSizer:
    """Per-shard shape calculator (reference role:
    ``ndsl.initialization.SubtileGridSizer``, used through
    ``QuantityFactory``).

    Computes dim-name -> length maps for one subtile shard given the global
    cube size and rank layout. ``nx``/``ny``/``nz`` are the *per-shard*
    compute extents; interface dims get +1, horizontal dims carry ``n_halo``
    ghost points per side.
    """

    nx: int
    ny: int
    nz: int
    n_halo: int = constants.N_HALO_DEFAULT

    @classmethod
    def from_tile_params(
        cls,
        nx_tile: int,
        ny_tile: int,
        nz: int,
        n_halo: int = constants.N_HALO_DEFAULT,
        layout: Tuple[int, int] = (1, 1),
    ) -> "SubtileGridSizer":
        if nx_tile % layout[1] or ny_tile % layout[0]:
            raise ValueError(
                f"tile size ({ny_tile}, {nx_tile}) not divisible by layout {layout}"
            )
        return cls(
            nx=nx_tile // layout[1], ny=ny_tile // layout[0], nz=nz, n_halo=n_halo
        )

    @property
    def sizes(self) -> Mapping[str, int]:
        return {"x": self.nx, "y": self.ny, "z": self.nz, "tile": 6}

    def get_extent(self, dims: Sequence[str]) -> Tuple[int, ...]:
        out = []
        for d in dims:
            base = d.replace("_interface", "")
            out.append(self.sizes[base] + (1 if d.endswith("_interface") else 0))
        return tuple(out)

    def get_origin(self, dims: Sequence[str]) -> Tuple[int, ...]:
        return tuple(
            self.n_halo if d.replace("_interface", "") in ("x", "y") else 0
            for d in dims
        )

    def get_shape(self, dims: Sequence[str]) -> Tuple[int, ...]:
        return tuple(
            e + 2 * o for e, o in zip(self.get_extent(dims), self.get_origin(dims))
        )


@dataclasses.dataclass(frozen=True)
class QuantityFactory:
    """Allocate Quantities by dim names (reference role:
    ``ndsl.QuantityFactory``). No backend zoo: tensors live on ``device``,
    the card unless the caller asks for the CPU."""

    sizer: SubtileGridSizer
    device: Any = "cuda"

    @classmethod
    def from_backend(cls, sizer: SubtileGridSizer, backend: str = "torch", device="cuda"):
        """Reference-signature constructor; ``backend`` is accepted for API
        parity and ignored (torch is the only backend)."""
        return cls(sizer, device)

    def _make(self, fill, dims, units, dtype):
        data = torch.full(self.sizer.get_shape(dims), fill, dtype=check_dtype(dtype),
                          device=resolve_device(self.device))
        return Quantity(
            data, dims, units, self.sizer.get_origin(dims), self.sizer.get_extent(dims)
        )

    def zeros(self, dims: Sequence[str], units: str, dtype=torch.float32) -> Quantity:
        return self._make(0, dims, units, dtype)

    def ones(self, dims: Sequence[str], units: str, dtype=torch.float32) -> Quantity:
        return self._make(1, dims, units, dtype)

    def empty(self, dims: Sequence[str], units: str, dtype=torch.float32) -> Quantity:
        # zeros rather than uninitialized memory: the same contents every time
        return self._make(0, dims, units, dtype)

    def from_array(self, data, dims: Sequence[str], units: str) -> Quantity:
        """Wrap an existing halo-inclusive array or tensor (shape must match
        the sizer) as a tensor on the factory's device."""
        expect = self.sizer.get_shape(dims)
        if tuple(data.shape) != expect:
            raise ValueError(f"array shape {tuple(data.shape)} != sizer shape {expect}")
        return Quantity(
            torch.as_tensor(data, device=resolve_device(self.device)),
            dims,
            units,
            self.sizer.get_origin(dims),
            self.sizer.get_extent(dims),
        )
