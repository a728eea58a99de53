"""Fortran namelist ingestion.

Port of ``pace_tpu.utils.namelist`` (reference role:
``ndsl.namelist.Namelist.from_f90nml``, which builds configs from the Fortran
model's input.nml). Self-contained parser, no f90nml package. Handles the
subset the FV3 namelists use: &group/end groups, scalar and comma-separated
values, Fortran logicals/floats, ! comments, repeated keys overridden
last-wins."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict


def _parse_value(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    tl = t.lower().rstrip(",")
    if tl in (".true.", "t", ".t.", "true"):
        return True
    if tl in (".false.", "f", ".f.", "false"):
        return False
    if (t[0] == t[-1] == "'") or (t[0] == t[-1] == '"'):
        return t[1:-1]
    try:
        return int(tl)
    except ValueError:
        pass
    try:
        return float(tl.replace("d", "e").replace("D", "e"))
    except ValueError:
        return t


def parse_f90nml(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into {group: {key: value}}; multi-valued entries
    become lists."""
    groups: Dict[str, Dict[str, Any]] = {}
    current = None
    for raw in text.splitlines():
        line = raw.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            current = line[1:].strip().lower()
            groups.setdefault(current, {})
            continue
        if line in ("/", "&end", "$end"):
            current = None
            continue
        if current is None or "=" not in line:
            continue
        key, _, rhs = line.partition("=")
        key = key.strip().lower()
        # strip trailing comma and split multi-values (respect quotes crudely)
        parts = [p for p in re.split(r",(?=(?:[^']*'[^']*')*[^']*$)", rhs) if p.strip()]
        vals = [_parse_value(p) for p in parts]
        groups[current][key] = vals[0] if len(vals) == 1 else vals
    return groups


@dataclasses.dataclass
class Namelist:
    """Flat view over the parsed groups (reference Namelist exposes fv_core_nml
    keys as attributes)."""

    groups: Dict[str, Dict[str, Any]]

    @classmethod
    def from_f90nml(cls, path_or_text: str) -> "Namelist":
        try:
            text = open(path_or_text).read()
        except (OSError, ValueError):
            text = path_or_text
        return cls(groups=parse_f90nml(text))

    def __getattr__(self, key: str):
        for group in self.groups.values():
            if key in group:
                return group[key]
        raise AttributeError(key)

    def get(self, key: str, default=None):
        for group in self.groups.values():
            if key in group:
                return group[key]
        return default

    def dycore_config(self):
        """Build a DynamicalCoreConfig from fv_core_nml keys (reference
        DynamicalCoreConfig.from_namelist analog)."""
        from ..models.fv3.dycore import DynamicalCoreConfig

        fields = {f.name for f in dataclasses.fields(DynamicalCoreConfig)}
        kwargs = {}
        core = self.groups.get("fv_core_nml", {})
        for key, val in core.items():
            if key in fields:
                kwargs[key] = val
        if "npz" in core:
            kwargs["npz"] = core["npz"]
        return DynamicalCoreConfig(**kwargs)
