"""The comparison that decides ``correct``.

The program's outputs are held against the reference (``reference/``, a
frozen plain copy that imports nothing of the program), which works out
every derived input again from the configuration and the seed:

- ``grid_gap``: the grid the program's set-up derived (every tensor of its
  ``GridData``, the worst) against the reference's, from the same
  configuration;
- ``init_gap``: the initial state the set-up derived and seeded, before
  the warm-up step (every field, the worst), against the reference's
  analytic state with the same seeded inputs;
- ``warm.<field>``: the warm-up step, the program's first step through
  ``Driver.step_all``, against the reference's step from its own seeded
  initial state: a step whose input owes nothing to the program, field by
  field (each tracer by name; with physics, each field of the surface
  state as ``warm.surface.<field>``);
- ``step.<field>``: one step of the forecast the window drove, taken by the
  program through ``Driver.step_all`` after the window (the first
  diagnostics step after it, in traced and untraced runs alike), against
  the reference's step from the program's own state before it, field by
  field. The reference cannot follow a forecast of tens of steps in the
  time of a run, so it follows the first step and the last one; the start
  is checked by the two gaps above;
- ``diag.<field>``: the diagnostics record that step wrote to disk against
  the reference's fields after its step;
- ``warm_rms.<field>``, ``step_rms.<field>``: the same steps' fields by
  their rms gap, for the fields whose largest gap float32 rounding alone
  makes as large as a control's (threshold processes of the physics).

On a mesh of N ranks (a cell with ``chips`` N) each rank holds its block of
the shards on both sides and computes the parts of each gap (:func:`gap_parts`,
:func:`rms_parts`); the ranks combine them (largest, or sum) into the whole
cube's, so that every number is the one a single process would compute, the
rms gaps to rounding.

A gap is ``max |program - reference| / max |reference|`` of a field, over
the compute domain for the stepped fields (halos hold stale values by
design) and over the whole array for the grid and the initial state. Each
field has its own limit (the cell's ``limits``): the fields differ by orders
of magnitude in how far float32 rounding moves them in a step. NaN or infinity in the program where the
reference is finite reads as infinite.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

#: the tracer axis's names, in order (the program's ``constants.TRACER_NAMES``)
TRACER_NAMES = ("qvapor", "qliquid", "qice", "qrain", "qsnow", "qgraupel", "qo3mr",
                "qsgs_tke", "qcld")


class Parts(NamedTuple):
    """What one rank's block of shards contributes to a gap: values that
    combine over the ranks by their largest (``kind`` ``"max"``) or by their
    sum (``"sum"``)."""

    kind: str
    values: Tuple[float, ...]


#: the parts of a field that is missing or malformed: the gap reads infinite
MISSING = Parts("max", (1.0, 0.0, 0.0))


def gap_parts(prog: torch.Tensor, ref: torch.Tensor, n_halo: Optional[int]) -> Parts:
    """The parts of :func:`field_gap` over the fields' shards: ``(bad,
    largest |prog - ref|, largest finite |ref|)``, ``bad`` 1 where the shapes
    differ or a difference is NaN. The parts of several blocks of shards
    combine by their largest (:func:`combine`), into the parts of the whole
    cube exactly."""
    r = ref.detach().to(torch.float64)
    p = prog.detach().to(r.device, torch.float64)
    if p.shape != r.shape:
        return MISSING
    if n_halo:
        h = n_halo
        p, r = p[..., h:-h, h:-h], r[..., h:-h, h:-h]
    same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    diff = torch.where(same, torch.zeros_like(p), (p - r).abs())
    if torch.isnan(diff).any():
        return MISSING
    finite = r[torch.isfinite(r)]
    scale = float(finite.abs().max()) if finite.numel() else 0.0
    worst = float(diff.max()) if diff.numel() else 0.0
    return Parts("max", (0.0, worst, scale))


def rms_parts(prog: torch.Tensor, ref: torch.Tensor, n_halo: Optional[int]) -> Parts:
    """The parts of :func:`field_rms_gap` over the fields' shards: ``(sum of
    (prog - ref)^2, sum of ref^2, points)``, which combine by their sum."""
    r = ref.detach().to(torch.float64)
    p = prog.detach().to(r.device, torch.float64)
    if n_halo:
        h = n_halo
        p, r = p[..., h:-h, h:-h], r[..., h:-h, h:-h]
    return Parts("sum", (float((p - r).square().sum()), float(r.square().sum()),
                         float(r.numel())))


def finish(parts: Parts) -> float:
    """The gap that combined parts give."""
    if parts.kind == "sum":
        d2, r2, n = parts.values
        if n <= 0:
            return math.inf
        den, num = math.sqrt(r2 / n), math.sqrt(d2 / n)
        return num / den if den > 0 else (0.0 if num == 0 else math.inf)
    bad, worst, scale = parts.values
    if bad:
        return math.inf
    if worst == 0.0:
        return 0.0
    return worst / scale if scale > 0 else math.inf


def combine(parts: Sequence[Parts]) -> Parts:
    """The parts of the union of the blocks whose parts these are."""
    kind = parts[0].kind
    cols = zip(*(p.values for p in parts))
    return Parts(kind, tuple((sum if kind == "sum" else max)(c) for c in cols))


def field_gap(prog: torch.Tensor, ref: torch.Tensor, n_halo: Optional[int]) -> float:
    """``max |prog - ref| / max |ref|`` in float64, on the reference's
    device; ``n_halo``: compare the compute domain only (None: the whole
    array). Points where both hold the same non-finite value count as
    equal."""
    return finish(gap_parts(prog, ref, n_halo))


def field_rms_gap(prog: torch.Tensor, ref: torch.Tensor, n_halo: Optional[int]) -> float:
    """``rms(prog - ref) / rms(ref)`` over the compute domain, in float64 on
    the reference's device."""
    r = ref.detach().to(torch.float64)
    p = prog.detach().to(r.device, torch.float64)
    if n_halo:
        h = n_halo
        p, r = p[..., h:-h, h:-h], r[..., h:-h, h:-h]
    den = float(r.square().mean().sqrt())
    num = float((p - r).square().mean().sqrt())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def field_gaps(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
               n_halo: Optional[int], prefix: str = "", gap=None,
               missing=math.inf) -> Dict[str, float]:
    """``{prefix + field: gap}`` over the fields of ``ref`` (a field missing
    from ``prog`` reads as ``missing``); the tracer block ``q`` counts
    tracer by tracer, by name. ``gap``: :func:`field_gap` unless given."""
    gap = gap or field_gap
    out = {}
    for name, r in ref.items():
        p = prog.get(name)
        if p is None:
            out[prefix + name] = missing
        elif name == "q" and r.dim() == 5:
            for i, tracer in enumerate(TRACER_NAMES[:r.shape[1]]):
                out[prefix + tracer] = gap(p[:, i], r[:, i], n_halo)
        else:
            out[prefix + name] = gap(p, r, n_halo)
    return out


def worst(gaps: Mapping[str, float]) -> Tuple[float, str]:
    """The largest gap and its field."""
    if not gaps:
        return math.inf, "(nothing compared)"
    name = max(gaps, key=lambda k: gaps[k])
    return gaps[name], name


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """Every number against its limit (a number at or under its limit
    passes; a missing or non-finite number fails, and so does any number
    whose limit is not set yet). Returns ``(correct,
    {name: {"value", "limit"}})`` in the order of ``limits``."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        passed = limit is not None and v is not None and math.isfinite(v) and v <= limit
        ok = ok and passed
        checks[name] = {"value": v if v is not None and math.isfinite(v) else None,
                        "limit": limit}
    return ok, checks


def tensors_of(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensor leaves of a (nested) dataclass by dotted field name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(tensors_of(v, prefix + f.name + "."))
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
    return out


def to_host(fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in fields.items()}
