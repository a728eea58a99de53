"""Checkpoint and resume: save and load the DycoreState and the surface state.

Port of ``pace_tpu.driver.restart`` (reference role: ``DriverState.save_state``
and the restart of the driver state). Restarts are HDF5 files with one
float64 dataset per field, written and read as ``pace_tpu`` writes and reads
them: the same file names, dataset names, dtypes and attributes, so that a
restart one package writes loads in the other. ``h5py`` is imported only
here, when a restart is written or read.

The surface datasets are named as ``jax.tree_util.keystr`` names the leaves of
``pace_tpu``'s dataclass pytrees (``.precip``, ``.lsm.tskin``, ``.ice.h_ice``,
...; a ``None`` field has no leaf): :func:`surface_leaves` walks the port's
dataclasses the same way.
"""

from __future__ import annotations

import dataclasses
import os

from ..dtypes import to_tensor
from ..models.fv3.state import DycoreState
from ..utils.ranges import host_sync

_FIELDS = (
    "u",
    "v",
    "delp",
    "pt",
    "q",
    "w",
    "delz",
    "phis",
    "ps",
    "pe",
    "peln",
    "pk",
    "pkz",
    "omga",
)

_DYCORE_FILE = "restart_dycore_state.h5"
_SURFACE_FILE = "restart_surface_state.h5"


def save_restart(path: str, state: DycoreState, time_seconds: float = 0.0):
    import h5py

    from ..utils import filesystem

    filesystem.get_fs(path).makedirs(path, exist_ok=True)
    with h5py.File(os.path.join(path, _DYCORE_FILE), "w") as f:
        f.attrs["time_seconds"] = float(time_seconds)
        for name in _FIELDS:
            val = getattr(state, name)
            if val is not None:
                with host_sync("restart"):
                    data = val.detach().cpu().numpy()
                f.create_dataset(name, data=data, dtype="f8")


def load_restart(path: str, device, dtype) -> DycoreState:
    """The state saved in ``path``, on ``device`` in ``dtype``; the fields
    a restart does not hold (the A/C-grid winds, the accumulated fluxes)
    are ``None`` until the next step fills them."""
    import h5py

    kwargs = {}
    with h5py.File(os.path.join(path, _DYCORE_FILE), "r") as f:
        for name in _FIELDS:
            if name in f:
                kwargs[name] = f[name][...]
    return DycoreState.from_numpy(kwargs, device=device, dtype=dtype)


def restart_time(path: str) -> float:
    import h5py

    with h5py.File(os.path.join(path, _DYCORE_FILE), "r") as f:
        return float(f.attrs.get("time_seconds", 0.0))


def surface_leaves(state, prefix: str = ""):
    """``[(name, tensor)]`` of a (nested) dataclass of tensors, in field
    order, named as ``jax.tree_util.keystr`` names a registered dataclass's
    leaves; ``None`` fields are skipped."""
    out = []
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        name = f"{prefix}.{f.name}"
        if val is None:
            continue
        if dataclasses.is_dataclass(val):
            out += surface_leaves(val, name)
        else:
            out.append((name, val))
    return out


def _fill(template, values: dict, prefix: str = ""):
    """``template`` with each leaf replaced by ``values[name]``, in the
    leaf's dtype and on its device."""
    new = {}
    for f in dataclasses.fields(template):
        val = getattr(template, f.name)
        name = f"{prefix}.{f.name}"
        if val is None:
            continue
        if dataclasses.is_dataclass(val):
            new[f.name] = _fill(val, values, name)
            continue
        if name not in values:
            raise KeyError(
                f"surface restart missing dataset {name!r} (available: {sorted(values)})"
            )
        new[f.name] = to_tensor(values[name], val.device, val.dtype)
    return dataclasses.replace(template, **new)


def save_surface_restart(path: str, surface_state) -> None:
    """Persist the interactive surface's state next to the dycore restart,
    one dataset per leaf, so that a coupled run resumes bit for bit."""
    import h5py

    from ..utils import filesystem

    filesystem.get_fs(path).makedirs(path, exist_ok=True)
    with h5py.File(os.path.join(path, _SURFACE_FILE), "w") as f:
        for name, leaf in surface_leaves(surface_state):
            with host_sync("restart"):
                data = leaf.detach().cpu().numpy()
            f.create_dataset(name, data=data, dtype="f8")


def has_surface_restart(path: str) -> bool:
    return os.path.exists(os.path.join(path, _SURFACE_FILE))


def load_surface_restart(path: str, template):
    """``template`` (a freshly initialized SurfaceState with the right
    structure, shapes, dtype and device) filled with the saved leaves."""
    import h5py

    with h5py.File(os.path.join(path, _SURFACE_FILE), "r") as f:
        values = {name: f[name][...] for name in f}
    return _fill(template, values)

