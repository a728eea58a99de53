"""A strict dict -> dataclass loader for configurations, and the ``{type,
config}`` registry of pluggable components.

Port of ``pace_tpu.utils.registry`` (reference role: the ``dacite`` loading
of the driver's YAML sections, strict about unknown keys, and ``ndsl``'s
``Registry``). Pure Python; the port keeps its own copy so that it imports
nothing of ``pace_tpu``.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Dict, Mapping, Type, Union, get_args, get_origin


class ConfigError(ValueError):
    pass


def _is_optional(tp) -> bool:
    return get_origin(tp) is Union and type(None) in get_args(tp)


def from_dict(cls: Type, data: Mapping[str, Any]):
    """Strictly build a (possibly nested) dataclass from a mapping.

    Unknown keys raise; missing keys without defaults raise. Nested dataclass
    fields recurse; ``Optional[Dataclass]`` and lists/tuples of dataclasses
    are handled. Scalars pass through with a light cast for int -> float.
    """
    if data is None:
        data = {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(field_map)
    if unknown:
        raise ConfigError(
            f"unknown key(s) {sorted(unknown)} for {cls.__name__}; "
            f"valid keys: {sorted(field_map)}"
        )
    # resolve postponed (string) annotations to real types
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    kwargs: Dict[str, Any] = {}
    for name, field in field_map.items():
        if name not in data:
            continue
        tp = hints.get(name, field.type)
        kwargs[name] = _convert(tp, data[name], f"{cls.__name__}.{name}")
    return cls(**kwargs)


def _convert(tp, value, where: str):
    # an annotation left as a string is not resolved: the value passes
    if isinstance(tp, str):
        return value
    origin = get_origin(tp)
    if _is_optional(tp):
        if value is None:
            return None
        inner = [a for a in get_args(tp) if a is not type(None)]
        return _convert(inner[0], value, where)
    if dataclasses.is_dataclass(tp):
        if isinstance(tp, type) and isinstance(value, tp):
            return value
        if not isinstance(value, Mapping):
            raise ConfigError(f"{where}: expected mapping for {tp}")
        return from_dict(tp, value)
    if origin in (list, tuple):
        args = get_args(tp)
        inner = args[0] if args else None
        converted = [
            _convert(inner, v, f"{where}[{i}]") if inner else v
            for i, v in enumerate(value)
        ]
        return tuple(converted) if origin is tuple else converted
    if tp is float and isinstance(value, int):
        return float(value)
    if tp is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(tp, type) and tp is not Any and not isinstance(value, tp):
        # duck typing for other types; the basic ones are enforced
        if tp in (int, float, str, bool):
            raise ConfigError(
                f"{where}: expected {tp.__name__}, got {type(value).__name__}"
            )
    return value


class Registry:
    """Registry of named config types, built from ``{type, config}`` dicts.

    Example::

        registry = Registry()

        @registry.register("analytic")
        @dataclasses.dataclass
        class AnalyticInit:
            case: str = "baroclinic"

        obj = registry.from_dict({"type": "analytic", "config": {"case": "baroclinic"}})
    """

    def __init__(self, default_type: str | None = None):
        self._types: Dict[str, Type] = {}
        self.default_type = default_type

    def register(self, type_name: str) -> Callable[[Type], Type]:
        def decorator(cls: Type) -> Type:
            self._types[type_name] = cls
            return cls

        return decorator

    @property
    def registered_types(self):
        return dict(self._types)

    def from_dict(self, config: Mapping[str, Any]):
        type_name = config.get("type", self.default_type)
        if type_name is None:
            raise ConfigError("no 'type' key and no default type registered")
        if type_name not in self._types:
            raise ConfigError(
                f"unknown type {type_name!r}; registered: {sorted(self._types)}"
            )
        return from_dict(self._types[type_name], config.get("config", {}))
