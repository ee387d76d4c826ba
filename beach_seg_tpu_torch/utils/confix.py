"""Structured-config engine: dataclass configs + dotlist CLI merge + YAML I/O.

The reference drives every entry point with OmegaConf structured configs merged
with a dotlist CLI (``src/train.py:31-36``,
``src/predict.py:166-171``). OmegaConf is not available here, so this module
provides the same surface on plain dataclasses:

    conf = parse_cli(BeachSegConfig, sys.argv[1:])    # key=value dotlist
    save_yaml(conf, path); conf2 = load_yaml(BeachSegConfig, path)

Type coercion follows the declared dataclass field types, including
``Path``, ``tuple[...]``, ``Optional`` and nested dataclasses.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from pathlib import Path
from typing import Any, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


class ConfigError(ValueError):
    pass


def _strip_optional(tp: Any) -> tuple[Any, bool]:
    """Return (inner_type, is_optional)."""
    origin = get_origin(tp)
    if origin is Union or origin is types.UnionType:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
        return tp, True
    return tp, False


def _coerce_scalar(value: Any, tp: Any) -> Any:
    if tp is Any or tp is None:
        return value
    if tp is bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("true", "1", "yes", "on"):
            return True
        if s in ("false", "0", "no", "off"):
            return False
        raise ConfigError(f"cannot parse bool from {value!r}")
    if tp is int:
        return int(value)
    if tp is float:
        return float(value)
    if tp is str:
        return str(value)
    if tp is Path:
        return Path(value)
    if isinstance(tp, type) and issubclass(tp, str):  # str enums
        return tp(value)
    return value


def _parse_seq_string(s: str) -> list[str]:
    """Parse '[a,b,c]' or 'a,b,c' into parts."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        s = s[1:-1]
    elif s.startswith("(") and s.endswith(")"):
        s = s[1:-1]
    if not s:
        return []
    return [p.strip() for p in s.split(",") if p.strip() != ""]


def coerce(value: Any, tp: Any) -> Any:
    """Coerce ``value`` (often a CLI/YAML string) to the annotated type."""
    tp, is_opt = _strip_optional(tp)
    if is_opt and (value is None or (isinstance(value, str) and value.lower() in ("none", "null"))):
        return None
    origin = get_origin(tp)
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    if origin in (tuple, list):
        args = get_args(tp)
        if isinstance(value, str):
            parts: list[Any] = _parse_seq_string(value)
        elif isinstance(value, (list, tuple)):
            parts = list(value)
        else:
            parts = [value]
        if origin is tuple:
            if args and args[-1] is Ellipsis:
                elem = args[0]
                return tuple(coerce(p, elem) for p in parts)
            if args and len(args) == len(parts):
                return tuple(coerce(p, a) for p, a in zip(parts, args))
            if args:
                elem = args[0]
                return tuple(coerce(p, elem) for p in parts)
            return tuple(parts)
        elem = args[0] if args else Any
        return [coerce(p, elem) for p in parts]
    if origin is dict:
        return dict(value)
    return _coerce_scalar(value, tp)


def from_dict(cls: type[T], data: dict[str, Any]) -> T:
    """Instantiate dataclass ``cls`` from a (possibly string-valued) dict."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{cls} is not a dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, val in data.items():
        if key not in fields:
            raise ConfigError(f"unknown config key {key!r} for {cls.__name__}")
        kwargs[key] = coerce(val, hints.get(key, Any))
    return cls(**kwargs)


def to_dict(conf: Any) -> dict[str, Any]:
    """Dataclass → plain YAML-safe dict (Paths→str, tuples→lists)."""

    def conv(v: Any) -> Any:
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, (tuple, list)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return conv(conf)


def merge_dotlist(conf: T, dotlist: list[str]) -> T:
    """Apply ``key=value`` / ``a.b.c=value`` overrides, returning a new config."""
    updates: dict[str, Any] = {}
    for item in dotlist:
        if "=" not in item:
            raise ConfigError(f"expected key=value, got {item!r}")
        key, val = item.split("=", 1)
        updates[key.strip()] = val

    def apply(obj: Any, key_path: list[str], val: Any) -> Any:
        hints = typing.get_type_hints(type(obj))
        name = key_path[0]
        field_names = {f.name for f in dataclasses.fields(obj)}
        if name not in field_names:
            raise ConfigError(f"unknown config key {name!r} for {type(obj).__name__}")
        if len(key_path) == 1:
            new_val = coerce(val, hints.get(name, Any))
        else:
            new_val = apply(getattr(obj, name), key_path[1:], val)
        return dataclasses.replace(obj, **{name: new_val})

    for key, val in updates.items():
        conf = apply(conf, key.split("."), val)
    return conf


def parse_cli(cls: type[T], argv: list[str], defaults: T | None = None) -> T:
    """Build ``cls()`` (or start from ``defaults``) and merge CLI dotlist."""
    conf = defaults if defaults is not None else cls()
    return merge_dotlist(conf, list(argv))


def save_yaml(conf: Any, path: Path | str) -> None:
    import yaml  # here, not at import: the engines import this module on hosts without PyYAML

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(conf), f, sort_keys=False)


def load_yaml(cls: type[T], path: Path | str) -> T:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return from_dict(cls, data)


def merge_yaml_into(conf: T, path: Path | str, skip: set[str] | None = None) -> T:
    """Overlay YAML values onto ``conf`` (used to re-load a train run's conf)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    hints = typing.get_type_hints(type(conf))
    field_names = {f.name for f in dataclasses.fields(conf)}
    updates = {}
    for key, val in data.items():
        if key not in field_names or (skip and key in skip):
            continue
        updates[key] = coerce(val, hints.get(key, Any))
    return dataclasses.replace(conf, **updates)
