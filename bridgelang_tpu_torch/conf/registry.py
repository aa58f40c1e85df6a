"""Typed-dataclass config registry + CLI binding (host only).

The port's copy of bridgelang_tpu/conf/registry.py: every experiment is a
frozen dataclass registered under a string id, selectable with
`--<group>.type <id>`, any field overridable from the command line, and the
resolved config serialized to the run dir as JSON. Standard library only, as
in the JAX package (the reference's draccus surface without draccus).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import MISSING, dataclass, fields, is_dataclass
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


class ChoiceRegistry:
    """Subclass this on a dataclass family; register concrete variants by id."""

    _registry: Dict[str, type]

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # Each direct subclass of ChoiceRegistry roots its own registry.
        if ChoiceRegistry in cls.__bases__:
            cls._registry = {}

    @classmethod
    def register_subclass(cls, choice_id: str, subclass: Optional[type] = None):
        def _register(sc: type) -> type:
            if choice_id in cls._registry:
                raise ValueError(f"Choice id {choice_id!r} already registered on {cls.__name__}")
            cls._registry[choice_id] = sc
            sc.type_id = choice_id
            return sc

        return _register(subclass) if subclass is not None else _register

    @classmethod
    def get_choice_class(cls, choice_id: str) -> type:
        if choice_id not in cls._registry:
            raise KeyError(
                f"Unknown {cls.__name__} id {choice_id!r}; available: {sorted(cls._registry)}"
            )
        return cls._registry[choice_id]

    @classmethod
    def get_choice_name(cls, subclass: type) -> str:
        for k, v in cls._registry.items():
            if v is subclass:
                return k
        raise KeyError(f"{subclass} not registered on {cls.__name__}")

    @classmethod
    def available(cls) -> List[str]:
        return sorted(cls._registry)

    @classmethod
    def get(cls: Type[T], choice_id: str, **overrides: Any) -> T:
        return cls.get_choice_class(choice_id)(**overrides)  # type: ignore[call-arg]


# --- (de)serialization -------------------------------------------------------


def config_to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        out = {"type": getattr(cfg, "type_id", None)} if hasattr(cfg, "type_id") else {}
        for f in fields(cfg):
            out[f.name] = config_to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, Enum):
        return cfg.value
    if isinstance(cfg, Path):
        return str(cfg)
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    return cfg


def save_config(cfg: Any, path: Union[str, Path]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, default=str)


def _resolve_annotation(annotation: Any, owner_module: Optional[str] = None) -> Any:
    """Resolve postponed (string) annotations best-effort, consulting the
    owning module's globals so project types (VLAConfig, ...) resolve."""
    if not isinstance(annotation, str):
        return annotation
    import typing

    ns = {**vars(typing), "Path": Path, "int": int, "float": float, "bool": bool, "str": str}
    if owner_module and owner_module in sys.modules:
        ns = {**sys.modules[owner_module].__dict__, **ns}
    try:
        return eval(annotation, ns)  # noqa: S307 — annotations are first-party source
    except Exception:
        return str


def _coerce(annotation: Any, raw: Any) -> Any:
    """Coerce a CLI string (or JSON value) to the annotated field type."""
    annotation = _resolve_annotation(annotation)
    origin = get_origin(annotation)
    if origin is Union:  # Optional[X] and friends
        args = [a for a in get_args(annotation) if a is not type(None)]
        if raw is None or (isinstance(raw, str) and raw.lower() in ("none", "null")):
            return None
        return _coerce(args[0], raw) if args else raw
    if annotation is bool:
        if isinstance(raw, bool):
            return raw
        return str(raw).lower() in ("1", "true", "yes", "on")
    if annotation is int:
        return int(raw)
    if annotation is float:
        return float(raw)
    if annotation is Path:
        return Path(raw)
    if isinstance(annotation, type) and issubclass(annotation, Enum):
        try:
            return annotation(raw)
        except ValueError:
            return annotation[raw]
    if origin in (list, tuple, dict):
        val = json.loads(raw) if isinstance(raw, str) else raw
        return origin(val) if origin is not dict else dict(val)
    return raw


def _build(cls: type, values: Dict[str, Any]) -> Any:
    """Instantiate a (possibly ChoiceRegistry-rooted) dataclass from a value dict."""
    if isinstance(cls, type) and issubclass(cls, ChoiceRegistry):
        choice_id = values.pop("type", None)
        if choice_id is not None:
            cls = cls.get_choice_class(choice_id)
    kwargs: Dict[str, Any] = {}
    for f in fields(cls):
        if f.name in values:
            raw = values[f.name]
            if is_dataclass(f.type) or (isinstance(f.type, type) and is_dataclass(f.type)):
                kwargs[f.name] = _build(f.type, raw if isinstance(raw, dict) else {})
            else:
                kwargs[f.name] = _coerce(f.type, raw)
        elif isinstance(f.type, type) and is_dataclass(f.type) and f.default is MISSING and f.default_factory is MISSING:  # type: ignore[misc]
            kwargs[f.name] = _build(f.type, {})
    return cls(**kwargs)


def parse_cli(config_cls: Type[T], argv: Optional[List[str]] = None) -> T:
    """Parse `--a.b.c value` style overrides into a top-level config dataclass.

    Mirrors the reference's `@draccus.wrap()` entry-point pattern
    (reference: vla-scripts/train.py:106-138) without the draccus dependency.
    Nested ChoiceRegistry fields are selected with `--field.type <id>` and then
    rebuilt with any sibling overrides applied on top of the variant defaults.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    tree: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"Unexpected CLI token {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"Missing value for --{key}")
            val = argv[i + 1]
            i += 2
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    # Instantiate: nested dataclass fields get defaults first, then overrides.
    kwargs: Dict[str, Any] = {}
    for f in fields(config_cls):
        ftype = _resolve_annotation(f.type, owner_module=config_cls.__module__)
        if f.name in tree:
            raw = tree.pop(f.name)
            if isinstance(raw, dict):
                base_cls = ftype
                if isinstance(base_cls, type) and issubclass(base_cls, ChoiceRegistry) and "type" in raw:
                    base_cls = base_cls.get_choice_class(raw.pop("type"))
                elif f.default is not MISSING and f.default is not None:
                    base_cls = type(f.default)
                elif f.default_factory is not MISSING:  # type: ignore[misc]
                    base_cls = type(f.default_factory())  # type: ignore[misc]
                base = _default_of(f, base_cls)
                merged = {**{bf.name: getattr(base, bf.name) for bf in fields(base_cls)}}
                for k, v in raw.items():
                    ann = {bf.name: bf.type for bf in fields(base_cls)}.get(k, str)
                    merged[k] = _coerce(ann, v)
                kwargs[f.name] = base_cls(**merged)
            else:
                kwargs[f.name] = _coerce(ftype, raw)
    if tree:
        raise ValueError(f"Unknown CLI keys: {sorted(tree)}")
    return config_cls(**kwargs)


def _default_of(f: dataclasses.Field, cls: type) -> Any:
    if f.default is not MISSING and isinstance(f.default, cls):
        return f.default
    if f.default_factory is not MISSING:  # type: ignore[misc]
        d = f.default_factory()  # type: ignore[misc]
        if isinstance(d, cls):
            return d
    return cls()


__all__ = ["ChoiceRegistry", "parse_cli", "config_to_dict", "save_config", "dataclass"]
