"""Stage checkpointers: record / validate model state inside the dycore.

Port of ``pace_tpu.testing.checkpointer`` (reference role:
``ndsl.checkpointer``: ``ValidationCheckpointer`` with per-variable
absolute+relative thresholds, ``ThresholdCalibrationCheckpointer`` deriving
thresholds from round-off-perturbed trials with a safety factor, and a
committed thresholds YAML). Stage names mirror the reference savepoints:
``FVDynamics-In/Out``, ``C_SW-In/Out``, ``D_SW-Out``, ``Tracer2D1L-In/Out``,
``Remapping-In/Out`` and the physics' ``Physics-In/Out``.

A checkpointer takes each variable to the host (``.detach().cpu()``), so a
checkpointed step synchronizes with the device at every stage; without one
the step fires nothing. The thresholds YAML is read and written by the
port's YAML subset (:mod:`pace_tpu_torch.utils.yaml_subset`), and the
``.npz`` recordings have ``pace_tpu``'s layout, so recordings and
thresholds cross between the two packages in both directions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import yaml_subset


class ValidationError(AssertionError):
    pass


@dataclasses.dataclass
class Threshold:
    """Reference ``ndsl.checkpointer.Threshold``: a comparison passes if
    |a - b| <= absolute OR |a - b| <= relative * |b|, elementwise."""

    absolute: float
    relative: float

    def check(self, name: str, a: np.ndarray, b: np.ndarray) -> Optional[str]:
        diff = np.abs(a - b)
        ok = (diff <= self.absolute) | (diff <= self.relative * np.abs(b))
        # regions NaN-masked on BOTH sides are deliberately not validated
        # (selective validation, testing/validation.py) and always pass
        ok |= np.isnan(a) & np.isnan(b)
        diff = np.where(np.isnan(diff), 0.0, diff)
        if ok.all():
            return None
        worst = np.unravel_index(np.argmax(diff), diff.shape)
        return (
            f"{name}: {int((~ok).sum())} of {ok.size} points out of threshold "
            f"(abs={self.absolute:g}, rel={self.relative:g}); worst "
            f"|diff|={diff[worst]:g} at {worst} (a={a[worst]:g}, b={b[worst]:g})"
        )


@dataclasses.dataclass
class SavepointThresholds:
    """stage -> variable -> Threshold, with yaml round-trip matching the shape
    of the reference's committed thresholds file."""

    savepoints: Dict[str, Dict[str, Threshold]]

    def to_yaml(self, path: str) -> None:
        raw = {
            stage: {
                var: {"absolute": float(t.absolute), "relative": float(t.relative)}
                for var, t in vars_.items()
            }
            for stage, vars_ in self.savepoints.items()
        }
        with open(path, "w") as f:
            f.write(yaml_subset.dump(raw))

    @classmethod
    def from_yaml(cls, path: str) -> "SavepointThresholds":
        with open(path) as f:
            raw = yaml_subset.safe_load(f)
        return cls(
            savepoints={
                stage: {
                    var: Threshold(d["absolute"], d["relative"])
                    for var, d in vars_.items()
                }
                for stage, vars_ in raw.items()
            }
        )


def _concrete(arr) -> np.ndarray:
    """A host numpy array of a tensor (or of an array)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class SnapshotCheckpointer:
    """Record every (stage, variable) it sees — generates the reference data
    a ValidationCheckpointer later compares against."""

    def __init__(self):
        self.data: Dict[str, List[Dict[str, np.ndarray]]] = {}

    def __call__(self, stage: str, **variables):
        self.data.setdefault(stage, []).append(
            {k: _concrete(v).copy() for k, v in variables.items() if v is not None}
        )

    def save(self, path: str) -> None:
        flat = {}
        counts = {}
        for stage, hits in self.data.items():
            counts[stage] = len(hits)
            for i, hit in enumerate(hits):
                for var, arr in hit.items():
                    flat[f"{stage}|{i}|{var}"] = arr
        np.savez_compressed(path, __counts__=np.array(list(counts.items()), dtype=object), **flat)

    @classmethod
    def load(cls, path: str) -> "SnapshotCheckpointer":
        out = cls()
        data = np.load(path, allow_pickle=True)
        for key in data.files:
            if key == "__counts__":
                continue
            stage, i, var = key.split("|")
            i = int(i)
            hits = out.data.setdefault(stage, [])
            while len(hits) <= i:
                hits.append({})
            hits[i][var] = data[key]
        return out


class ValidationCheckpointer:
    """Compare each (stage, variable) against recorded reference data with
    per-variable thresholds (reference ValidationCheckpointer + .trial()).

    ``n_halo > 0`` compares each array without its outer ``n_halo`` rows and
    columns: the compute domain, with an interface array's extra row or
    column. The ghost cells hold values no stage computes (``pace_tpu``'s
    and the plain versions' agree there; the card's kernels leave other
    values), so this is how a run on the card is validated."""

    def __init__(self, reference: SnapshotCheckpointer,
                 thresholds: SavepointThresholds, n_halo: int = 0):
        self.reference = reference
        self.thresholds = thresholds
        self.n_halo = int(n_halo)
        self._hit: Dict[str, int] = {}
        self.errors: List[str] = []

    def trial(self):
        """Context manager starting a fresh pass over the reference data."""
        chk = self

        class _Trial:
            def __enter__(self):
                chk._hit = {}
                chk.errors = []
                return chk

            def __exit__(self, exc_type, exc, tb):
                if exc_type is None and chk.errors:
                    raise ValidationError("\n".join(chk.errors))
                return False

        return _Trial()

    def __call__(self, stage: str, **variables):
        i = self._hit.get(stage, 0)
        self._hit[stage] = i + 1
        ref_hits = self.reference.data.get(stage)
        if ref_hits is None or i >= len(ref_hits):
            self.errors.append(f"{stage}: no reference data for hit {i}")
            return
        ref = ref_hits[i]
        ths = self.thresholds.savepoints.get(stage, {})
        for var, val in variables.items():
            if val is None or var not in ref:
                continue
            th = ths.get(var, Threshold(absolute=0.0, relative=0.0))
            a, b = _concrete(val), ref[var]
            h = self.n_halo
            if h:
                a = a[..., h:a.shape[-2] - h, h:a.shape[-1] - h]
                b = b[..., h:b.shape[-2] - h, h:b.shape[-1] - h]
            msg = th.check(f"{stage}[{i}].{var}", a, b)
            if msg is not None:
                self.errors.append(msg)


class ThresholdCalibrationCheckpointer:
    """Accumulate max |divergence| from reference data over perturbed trials;
    thresholds = factor * max divergence (reference role:
    ``_calibrate_thresholds``, factor 10)."""

    def __init__(self, reference: SnapshotCheckpointer, factor: float = 10.0):
        self.reference = reference
        self.factor = float(factor)
        self._abs: Dict[str, Dict[str, float]] = {}
        self._rel: Dict[str, Dict[str, float]] = {}
        self._hit: Dict[str, int] = {}

    def trial(self):
        chk = self

        class _Trial:
            def __enter__(self):
                chk._hit = {}
                return chk

            def __exit__(self, exc_type, exc, tb):
                return False

        return _Trial()

    def __call__(self, stage: str, **variables):
        i = self._hit.get(stage, 0)
        self._hit[stage] = i + 1
        ref_hits = self.reference.data.get(stage)
        if ref_hits is None or i >= len(ref_hits):
            return
        ref = ref_hits[i]
        for var, val in variables.items():
            if val is None or var not in ref:
                continue
            a = _concrete(val)
            b = ref[var]
            diff = float(np.max(np.abs(a - b)))
            denom = np.abs(b)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(denom > 0, np.abs(a - b) / denom, 0.0)
            reldiff = float(np.max(rel))
            sa = self._abs.setdefault(stage, {})
            sr = self._rel.setdefault(stage, {})
            sa[var] = max(sa.get(var, 0.0), diff)
            sr[var] = max(sr.get(var, 0.0), reldiff)

    def thresholds(self) -> SavepointThresholds:
        out: Dict[str, Dict[str, Threshold]] = {}
        for stage in self._abs:
            out[stage] = {
                var: Threshold(
                    absolute=self.factor * self._abs[stage][var],
                    relative=self.factor * self._rel[stage][var],
                )
                for var in self._abs[stage]
            }
        return SavepointThresholds(savepoints=out)


class PairStageComparator:
    """Per-STAGE replica comparison for the driver's pair_debug mode
    (reference role: two split-comm replicas cross-check data around every
    stencil call). The comparator reuses the checkpointer stage hooks
    (C_SW/D_SW/Tracer2D1L/Remapping/FVDynamics In/Out) to name the first
    stage, variable, and hit where the replicas disagree.

    Usage: the primary model records stages into a SnapshotCheckpointer;
    the replica runs with this comparator, which consumes the recording in
    stage order. Call ``begin_step()`` before each primary step.
    """

    def __init__(self, snapshot: SnapshotCheckpointer):
        self.snapshot = snapshot
        self._idx: Dict[str, int] = {}

    def begin_step(self) -> None:
        """Clear the previous step's recording (call before the PRIMARY
        model's step so each step compares against fresh data)."""
        self.snapshot.data.clear()
        self._idx.clear()

    def __call__(self, stage: str, **variables):
        hits = self.snapshot.data.get(stage, [])
        i = self._idx.get(stage, 0)
        self._idx[stage] = i + 1
        if i >= len(hits):
            raise RuntimeError(
                f"pair_debug: replica fired stage {stage!r} hit {i} that the"
                " primary never recorded (control-flow divergence)"
            )
        ref = hits[i]
        for name, val in variables.items():
            if val is None:
                continue
            a = _concrete(val)
            b = ref.get(name)
            if b is None:
                raise RuntimeError(
                    f"pair_debug: replica stage {stage!r} produced variable"
                    f" {name!r} the primary did not record"
                )
            if not np.array_equal(a, b):
                d = np.abs(a - b)
                raise RuntimeError(
                    f"pair_debug: replica divergence at stage {stage!r},"
                    f" variable {name!r}, hit {i}:"
                    f" max|diff|={d.max():.6e} at {np.unravel_index(d.argmax(), d.shape)}"
                )
