"""Diagnostics: variable selection, derived quantities, monitor output.

Port of ``pace_tpu.driver.diagnostics`` (reference roles:
``DiagnosticsConfig``, ``MonitorDiagnostics``, ``ZSelect`` and ndsl's zarr
and NetCDF monitors). Three stores, selected by ``output_format``: ``zarr``
(the v2 directory format, written directly), ``netcdf`` (classic NetCDF-3,
buffered and written at cleanup) and ``hdf5`` (``h5py``, imported only when
that store is built). One dataset per variable, extended along a leading
time axis, float32; the grid's lat/lon written once as constants.

Only what was asked for leaves the device: each requested field's compute
domain (and each requested level of a ``z_select``), and the derived
column integrals, which are summed on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from ..utils.ranges import host_sync


@dataclasses.dataclass(frozen=True)
class ZSelect:
    """Output one vertical level of a 3D field."""

    level: int
    names: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DiagnosticsConfig:
    """``pace_tpu``'s fields and defaults."""

    path: str = "output"
    names: List[str] = dataclasses.field(default_factory=list)
    derived_names: List[str] = dataclasses.field(default_factory=list)
    z_select: List[ZSelect] = dataclasses.field(default_factory=list)
    output_format: str = "hdf5"
    output_frequency: int = 1
    output_initial_state: bool = False

    def diagnostics_factory(self, mt, n_halo: int):
        if not self.names and not self.derived_names and not self.z_select:
            return NullDiagnostics()
        return MonitorDiagnostics(self, mt, n_halo)


class NullDiagnostics:
    def store(self, time_seconds: float, state, extras=None):
        pass

    def store_grid(self, mt):
        pass

    def cleanup(self):
        pass


class _HDF5Store:
    def __init__(self, path: str):
        import h5py

        self.file = h5py.File(os.path.join(path, "diagnostics.h5"), "w")

    def append_time(self, name, it, arr):
        if name not in self.file:
            self.file.create_dataset(
                name,
                shape=(0,) + arr.shape,
                maxshape=(None,) + arr.shape,
                dtype="f4",
                chunks=(1,) + arr.shape,
            )
        ds = self.file[name]
        ds.resize(it + 1, axis=0)
        ds[it] = arr

    def write_constant(self, name, arr):
        self.file.create_dataset(name, data=np.asarray(arr, dtype=np.float32))

    def flush(self):
        self.file.flush()

    def close(self):
        self.file.close()


class _ZarrStore:
    """Per-variable chunked arrays in the zarr v2 directory format
    (:mod:`pace_tpu_torch.utils.zarr_v2`)."""

    def __init__(self, path: str):
        from ..utils.zarr_v2 import ZarrGroup

        self.group = ZarrGroup(path)

    def append_time(self, name, it, arr):
        self.group.append_time(name, it, arr)

    def write_constant(self, name, arr):
        self.group.write_constant(name, arr)

    def flush(self):
        pass

    def close(self):
        pass


class _NetCDFStore:
    """Buffered in memory, written as one classic NetCDF-3 file with an
    unlimited time axis at cleanup."""

    def __init__(self, path: str):
        self.path = os.path.join(path, "diagnostics.nc")
        self._times = {}
        self._consts = {}

    def append_time(self, name, it, arr):
        self._times.setdefault(name, []).append(np.asarray(arr, np.float32))

    def write_constant(self, name, arr):
        self._consts[name] = np.asarray(arr, dtype=np.float32)

    def flush(self):
        pass

    def close(self):
        from ..utils import netcdf3

        dims = {"time": None}
        variables = {}
        for name, recs in self._times.items():
            arr = np.stack(recs)
            dnames = ["time"]
            for ax, sz in enumerate(arr.shape[1:]):
                dn = f"{name}_d{ax}"
                dims[dn] = int(sz)
                dnames.append(dn)
            variables[name] = netcdf3.Variable(tuple(dnames), arr)
        for name, arr in self._consts.items():
            dnames = []
            for ax, sz in enumerate(arr.shape):
                dn = f"{name}_d{ax}"
                dims[dn] = int(sz)
                dnames.append(dn)
            variables[name] = netcdf3.Variable(tuple(dnames), arr)
        netcdf3.write(
            self.path,
            netcdf3.NetCDF3File(dims=dims, variables=variables, attrs={}),
        )


_STORES = {"hdf5": _HDF5Store, "zarr": _ZarrStore, "netcdf": _NetCDFStore}


class MonitorDiagnostics:
    def __init__(self, config: DiagnosticsConfig, mt, n_halo: int):
        self.config = config
        self.h = n_halo
        os.makedirs(config.path, exist_ok=True)
        if config.output_format not in _STORES:
            raise ValueError(
                f"unknown output_format {config.output_format!r}; choose "
                f"from {sorted(_STORES)}"
            )
        self.store_backend = _STORES[config.output_format](config.path)
        self.times: List[float] = []
        del mt

    def _interior(self, t) -> torch.Tensor:
        h = self.h
        return t[..., h:-h, h:-h]

    def _derive(self, name: str, state) -> torch.Tensor:
        """Derived variables: ``column_integrated_<tracer>``, the column
        integral of a tracer's mass, sum(q delp) / g."""
        from .. import constants
        from ..constants import TRACER_NAMES

        if name.startswith("column_integrated_"):
            tname = name[len("column_integrated_"):]
            q = state.q[:, TRACER_NAMES.index(tname)]
            return (q * state.delp).sum(dim=-3) / constants.GRAV
        raise KeyError(f"unknown derived diagnostic {name!r}")

    def store(self, time_seconds: float, state, extras=None):
        """``extras``: physics and surface fields (precipitation, skin
        temperature, ...) that do not live on the DycoreState, requested in
        ``names`` like any state field."""
        self.times.append(time_seconds)
        it = len(self.times) - 1
        for name in self.config.names:
            field = getattr(state, name, None)
            if field is None and extras is not None:
                field = extras.get(name)
            if field is None:
                raise ValueError(
                    f"diagnostic {name!r} requested but not filled by the "
                    "model (None in state)"
                )
            self._append(name, it, self._interior(field))
        for name in self.config.derived_names:
            self._append(name, it, self._interior(self._derive(name, state)))
        for zs in self.config.z_select:
            for name in zs.names:
                lvl = getattr(state, name)[..., zs.level, :, :]
                self._append(f"{name}_z{zs.level}", it, self._interior(lvl))
        self.store_backend.flush()

    def _append(self, name: str, it: int, t: torch.Tensor):
        with host_sync("diagnostics"):
            arr = t.detach().to(torch.float32).cpu().numpy()
        self.store_backend.append_time(name, it, arr)

    def store_grid(self, mt):
        """The grid's lat/lon (host arrays of the metric terms) as constants."""
        h = self.h
        self.store_backend.write_constant("lat", mt.lat_agrid[:, h:-h, h:-h])
        self.store_backend.write_constant("lon", mt.lon_agrid[:, h:-h, h:-h])

    def cleanup(self):
        if self.times:
            self.store_backend.write_constant(
                "time", np.asarray(self.times, dtype=np.float32)
            )
        self.store_backend.close()
