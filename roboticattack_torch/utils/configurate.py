"""Draccus-equivalent config machinery: dataclass configs + choice registries
+ YAML/JSON file loading + dotted CLI overrides.

The reference drives its trainer and eval scripts with draccus
(the reference's prismatic/conf/vla.py:20-57 ChoiceRegistry dataclasses;
run_bridgev2_eval.py:37-81 `@draccus.wrap()`): a run is a registered config
variant, optionally overridden from a config file and CLI flags. This module
provides the same workflow without the dependency:

    @dataclass
    class MyConfig(ChoiceRegistry): ...
    MyConfig.register_subclass("fast", FastVariant)

    cfg = parse_config(MyConfig, argv)          # --type fast --config_path f.yaml --lr 1e-4
    dump_config(cfg, "run/config.yaml")         # round-trips through load_config
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


class ChoiceRegistry:
    """Per-root-class registry of named config variants
    (draccus.ChoiceRegistry semantics)."""

    _choices: Dict[type, Dict[str, type]] = {}

    @classmethod
    def register_subclass(cls, name: str, subclass: Optional[type] = None):
        table = ChoiceRegistry._choices.setdefault(cls, {})

        def register(sub: type) -> type:
            table[name] = sub
            return sub

        return register(subclass) if subclass is not None else register

    @classmethod
    def get_choice_class(cls, name: str) -> type:
        table = ChoiceRegistry._choices.get(cls, {})
        if name not in table:
            raise KeyError(f"unknown {cls.__name__} choice '{name}'; "
                           f"registered: {sorted(table)}")
        return table[name]

    @classmethod
    def get_choice_name(cls, subclass: type) -> str:
        for name, registered in ChoiceRegistry._choices.get(cls, {}).items():
            if registered is subclass:
                return name
        raise KeyError(f"{subclass.__name__} is not registered under {cls.__name__}")

    @classmethod
    def registered_choices(cls) -> Dict[str, type]:
        return dict(ChoiceRegistry._choices.get(cls, {}))


def _autonum(value: Any) -> Any:
    """Untyped sequence elements from the CLI: int if it parses, else float,
    else the raw string."""
    if not isinstance(value, str):
        return value
    for caster in (int, float):
        try:
            return caster(value)
        except ValueError:
            continue
    return value


def _coerce(value: Any, annotation: Any) -> Any:
    """Best-effort coercion of a parsed (YAML/JSON/CLI string) value onto a
    dataclass field annotation, recursing into nested dataclasses."""
    if annotation is Any or value is None:
        return value
    origin = get_origin(annotation)
    if origin is Union:
        args = [a for a in get_args(annotation) if a is not type(None)]
        if not args:
            return value
        return _coerce(value, args[0])
    if dataclasses.is_dataclass(annotation) and isinstance(value, dict):
        return _from_dict(annotation, value)
    if origin in (list, tuple) or annotation in (list, tuple):
        if isinstance(value, str):  # CLI form: --field 1,2,3
            value = [v for v in value.split(",") if v != ""]
        inner = get_args(annotation)[0] if get_args(annotation) else Any
        if inner is Any:
            seq = [_autonum(v) for v in value]
        else:
            seq = [_coerce(v, inner) for v in value]
        return tuple(seq) if (origin is tuple or annotation is tuple) else seq
    if annotation is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "y", "on")
    if annotation in (int, float, str) and not isinstance(value, annotation):
        return annotation(value)
    return value


def _from_dict(cls: Type[T], blob: Dict[str, Any]) -> T:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in blob.items():
        if key == "type":
            continue
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field '{key}'")
        kwargs[key] = _coerce(value, fields[key].type if not isinstance(fields[key].type, str)
                              else _resolve_annotation(cls, key))
    return cls(**kwargs)


def _resolve_annotation(cls: type, field_name: str) -> Any:
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(field_name, Any)


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    out = dataclasses.asdict(cfg)
    # record the choice name when the instance is a registered variant
    for root in type(cfg).__mro__:
        if root in ChoiceRegistry._choices:
            for name, sub in ChoiceRegistry._choices[root].items():
                if type(cfg) is sub:
                    out["type"] = name
            break
    return out


def _read_blob(path: str) -> Dict[str, Any]:
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            blob = yaml.safe_load(f)
        else:
            blob = json.load(f)
    if not isinstance(blob, dict):
        raise ValueError(f"{path} must hold a mapping, got {type(blob).__name__}")
    return blob


def load_config(cls: Type[T], path: str) -> T:
    """YAML or JSON file -> dataclass instance. A 'type' key selects a
    registered choice subclass of `cls`."""
    blob = _read_blob(path)
    target = cls
    if "type" in blob and issubclass(cls, ChoiceRegistry):
        target = cls.get_choice_class(blob["type"])
    return _from_dict(target, blob)


def dump_config(cfg: Any, path: str) -> None:
    blob = config_to_dict(cfg)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            yaml.safe_dump(blob, f, sort_keys=False)
        else:
            json.dump(blob, f, indent=2, default=str)


def parse_config(cls: Type[T], argv=None, description: Optional[str] = None) -> T:
    """argparse front-end generated from the dataclass: `--type <choice>`,
    `--config_path <file>`, and one `--<field>` flag per field. Precedence:
    CLI flag > config file > variant defaults (draccus.wrap semantics)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--type", default=None)
    pre.add_argument("--config_path", default=None)
    known, _ = pre.parse_known_args(argv)

    if known.config_path:
        blob = _read_blob(known.config_path)
        choice = known.type or blob.get("type")  # explicit --type wins
        target = cls.get_choice_class(choice) if choice and issubclass(cls, ChoiceRegistry) else cls
        base = _from_dict(target, blob)
    else:
        target = cls.get_choice_class(known.type) if known.type else cls
        try:
            base = target()  # variant defaults live in the subclass constructor
        except TypeError:
            base = None  # fields without defaults must come from file/CLI

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--type", default=known.type)
    parser.add_argument("--config_path", default=known.config_path)
    import typing

    hints = typing.get_type_hints(target)
    for f in dataclasses.fields(target):
        default = getattr(base, f.name) if base is not None else (
            f.default if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING
                  else None)
        )
        parser.add_argument(f"--{f.name}", default=default)
    ns = parser.parse_args(argv)
    kwargs = {}
    for f in dataclasses.fields(target):
        value = getattr(ns, f.name)
        kwargs[f.name] = _coerce(value, hints.get(f.name, Any))
    return target(**kwargs)
