"""Halo-exchange strategies: stand-ins for the real exchange, chosen by config.

Port of ``pace_tpu.parallel.strategies`` (reference role: the driver's comm
backends ``NullComm``, ``CachingCommWriter`` and ``CachingCommReader``). Each
strategy has the exchanger's surface (``update_scalar`` / ``update_vector``
/ ``sync_vector_interfaces`` and the fold forms built on them), so the
dycore takes one in place of the real exchanger:

- :class:`ConstantFillHalo`: every ghost region filled with a constant
  (the driver's ``null`` comm: does the model run, whatever its answer).
- :class:`RecordingHalo`: runs the real exchange and keeps every result on
  the host; ``save()`` writes them to an ``.npz`` (``write``).
- :class:`ReplayHalo`: gives back a recording's results in order, with no
  exchange, and raises where the calls leave the recorded sequence
  (``read``).
- :class:`NanCheckingHalo`: raises on a NaN in the interior of any field
  entering an exchange.

A recording is a sequence of tagged results (``scalar:{stagger}:{fold}``,
``vector:{kind}:{fold}``, ``sync:{kind}``); the ``.npz`` holds ``ops`` and
``r0 .. rN``, the layout of ``pace_tpu``'s, so a recording made by either
package replays in the other. Every compound method reaches the tagged
primitives through :class:`_FoldsDefaultsMixin` in ``pace_tpu``'s order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.ranges import host_sync
from .halo_slabs import HaloUpdateHandle

_GEOMETRY = ("n_halo", "n_tile", "n_shards", "nsy", "nsx", "partitioner")


def _take_geometry(strategy, real_halo):
    for attr in _GEOMETRY:
        setattr(strategy, attr, getattr(real_halo, attr))


class _FoldsDefaultsMixin:
    """The exchanger's compound methods, each from the per-fold primitives,
    so that every strategy has the exchanger's whole surface."""

    def update_scalar_folds(self, q, stagger: str = "center"):
        return (
            self.update_scalar(q, stagger=stagger, fold="x"),
            self.update_scalar(q, stagger=stagger, fold="y"),
        )

    def update_scalars_folds(self, qs, stagger: str = "center"):
        xs = self.update_scalars(qs, stagger=stagger, fold="x")
        ys = self.update_scalars(qs, stagger=stagger, fold="y")
        return list(zip(xs, ys))

    def update_vector_folds(self, u, v, kind: str = "dgrid"):
        return (
            self.update_vector(u, v, kind=kind, fold="x"),
            self.update_vector(u, v, kind=kind, fold="y"),
        )

    def start_update_scalars_folds(self, qs, stagger: str = "center"):
        """A strategy has nothing in flight: the handle runs the whole
        exchange at ``wait()``."""
        qs = list(qs)
        return HaloUpdateHandle(lambda: self.update_scalars_folds(qs, stagger=stagger))

    def _patch_of(self, qy, n_halo=None):
        h = n_halo if n_halo is not None else getattr(self, "n_halo", 3)
        lo_r, hi_r = qy[..., :h, :], qy[..., -h:, :]
        return torch.cat(
            [
                torch.cat([lo_r[..., :h], lo_r[..., -h:]], dim=-1),
                torch.cat([hi_r[..., :h], hi_r[..., -h:]], dim=-1),
            ],
            dim=-2,
        )

    def update_scalar_fold_patch(self, q, stagger: str = "center"):
        """(x fold, the y fold's corner pack), the pack cut from the whole y
        fold."""
        qx, qy = self.update_scalar_folds(q, stagger=stagger)
        return qx, self._patch_of(qy)

    def update_scalars_fold_patches(self, qs, stagger: str = "center"):
        return [self.update_scalar_fold_patch(q, stagger=stagger) for q in qs]

    def start_update_scalars_fold_patches(self, qs, stagger: str = "center"):
        qs = list(qs)
        return HaloUpdateHandle(lambda: self.update_scalars_fold_patches(qs, stagger=stagger))

    def update_vector_fold_pair(
        self, u, v, kind: str = "dgrid", fold_u: str = "y", fold_v: str = "x"
    ):
        u_f, _ = self.update_vector(u, v, kind=kind, fold=fold_u)
        _, v_f = self.update_vector(u, v, kind=kind, fold=fold_v)
        return u_f, v_f


class ConstantFillHalo(_FoldsDefaultsMixin):
    """Every ghost region set to a constant; the interior untouched, the
    vector sync lines left as they are."""

    def __init__(self, real_halo, fill_value: float = 0.0):
        self._real = real_halo
        self.fill = float(fill_value)
        _take_geometry(self, real_halo)

    def _fill(self, q, stagger: str):
        h = self.n_halo
        out = q.clone()
        out[..., :h, :] = self.fill
        out[..., q.shape[-2] - h:, :] = self.fill
        out[..., :, :h] = self.fill
        out[..., :, q.shape[-1] - h:] = self.fill
        return out

    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        return self._fill(q, stagger)

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        return [self._fill(q, stagger) for q in qs]

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        return self._fill(u, kind), self._fill(v, kind)

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        return u, v


class RecordingHalo(_FoldsDefaultsMixin):
    """The real exchange, with every result copied to the host and tagged.
    ``save(path)`` writes them for :class:`ReplayHalo`."""

    def __init__(self, real_halo):
        self._real = real_halo
        self.records: List[np.ndarray] = []
        self._ops: List[str] = []
        _take_geometry(self, real_halo)

    def _record(self, tag: str, *arrays):
        for a in arrays:
            with host_sync("halo_record"):
                self.records.append(a.detach().cpu().numpy())
            self._ops.append(tag)

    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        out = self._real.update_scalar(q, stagger=stagger, fold=fold)
        self._record(f"scalar:{stagger}:{fold}", out)
        return out

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        return [self.update_scalar(q, stagger=stagger, fold=fold) for q in qs]

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        uo, vo = self._real.update_vector(u, v, kind=kind, fold=fold)
        self._record(f"vector:{kind}:{fold}", uo, vo)
        return uo, vo

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        uo, vo = self._real.sync_vector_interfaces(u, v, kind=kind)
        self._record(f"sync:{kind}", uo, vo)
        return uo, vo

    def save(self, path: str) -> None:
        np.savez(
            path,
            ops=np.array(self._ops),
            **{f"r{i}": r for i, r in enumerate(self.records)},
        )


class ReplayHalo(_FoldsDefaultsMixin):
    """A recorded exchange sequence given back in order, on the device of
    the field each call passes. Raises where the calls leave the
    recording."""

    def __init__(self, path_or_recording, real_halo=None):
        if isinstance(path_or_recording, RecordingHalo):
            self._ops = list(path_or_recording._ops)
            self._records = list(path_or_recording.records)
            real_halo = real_halo or path_or_recording._real
        else:
            with np.load(path_or_recording) as data:
                self._ops = [str(x) for x in data["ops"]]
                self._records = [data[f"r{i}"] for i in range(len(self._ops))]
        self._i = 0
        if real_halo is not None:
            _take_geometry(self, real_halo)

    def _next(self, tag: str, like):
        if self._i >= len(self._ops):
            raise RuntimeError("replay exhausted: more exchanges than recorded")
        if self._ops[self._i] != tag:
            raise RuntimeError(
                f"replay divergence at call {self._i}: recorded "
                f"{self._ops[self._i]!r}, requested {tag!r}"
            )
        out = self._records[self._i]
        self._i += 1
        return torch.from_numpy(np.array(out)).to(like.device)

    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        return self._next(f"scalar:{stagger}:{fold}", q)

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        return [self.update_scalar(q, stagger=stagger, fold=fold) for q in qs]

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        tag = f"vector:{kind}:{fold}"
        u_out = self._next(tag, u)
        v_out = self._next(tag, v)
        return u_out, v_out

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        tag = f"sync:{kind}"
        return self._next(tag, u), self._next(tag, v)


class NanCheckingHalo(_FoldsDefaultsMixin):
    """Raise ``FloatingPointError`` on a NaN in the interior of a field
    entering any exchange; NaN in the ghost rings is allowed."""

    def __init__(self, real_halo, name: Optional[str] = None):
        self._real = real_halo
        self.name = name or "halo"
        self.calls = 0
        _take_geometry(self, real_halo)

    def _check(self, tag, *arrays):
        self.calls += 1
        h = self.n_halo
        for a in arrays:
            with host_sync("nan_check"):
                nan = bool(torch.isnan(a[..., h:-h, h:-h]).any())
            if nan:
                raise FloatingPointError(
                    f"NaN in interior entering {self.name} exchange #{self.calls} ({tag})"
                )

    def update_scalar(self, q, stagger: str = "center", fold: str = "x"):
        self._check(f"scalar:{stagger}:{fold}", q)
        return self._real.update_scalar(q, stagger=stagger, fold=fold)

    def update_scalars(self, qs, stagger: str = "center", fold: str = "x"):
        for q in qs:
            self._check(f"scalars:{stagger}:{fold}", q)
        return self._real.update_scalars(qs, stagger=stagger, fold=fold)

    def update_vector(self, u, v, kind: str = "dgrid", fold: str = "x"):
        self._check(f"vector:{kind}:{fold}", u, v)
        return self._real.update_vector(u, v, kind=kind, fold=fold)

    def sync_vector_interfaces(self, u, v, kind: str = "dgrid"):
        self._check(f"sync:{kind}", u, v)
        return self._real.sync_vector_interfaces(u, v, kind=kind)
