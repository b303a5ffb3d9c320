"""YAML config loading with group composition and dotted overrides.

Counterpart of the JAX package's ``core/yaml_loader.py``, over the port's
own copy of its YAML files (``multi_modal_transformers_tokenmerge_torch/
configs/``), building the port's frozen dataclasses of ``core.config``.
Config groups are composed by a ``defaults`` list, with command-line-style
overrides; everything is materialized into the dataclasses at load time.

Layout::

    configs/
      octo_base.yaml, octo_base_tome.yaml, octo_deep.yaml
                              # root: scalars + defaults: {text: ..., ...}
      text/{t5_base,embed}.yaml
      images/gato_resnet.yaml
      transformer/{vanilla,tome,deep_tome}.yaml
      heads/{diffusion,continuous,categorical,all}.yaml

Usage::

    cfg = load_config("octo_base")
    cfg = load_config("octo_base", ["transformer.num_blocks=4",
                                    "heads=continuous", "dtype=bfloat16"])
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from typing import Any, Dict, List, Optional, Sequence, Union

import yaml

from .config import (
    CategoricalHeadConfig,
    ContinuousHeadConfig,
    DiffusionHeadConfig,
    HeadsConfig,
    ImageTokenizerConfig,
    OctoConfig,
    TextEncoderConfig,
    TransformerConfig,
)

__all__ = ["load_config", "config_from_dict", "apply_overrides",
           "CONFIG_DIR"]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")

# group name in the root yaml -> (dataclass, OctoConfig field name)
_GROUPS = {
    "text": (TextEncoderConfig, "text"),
    "images": (ImageTokenizerConfig, "images"),
    "transformer": (TransformerConfig, "transformer"),
    "heads": (HeadsConfig, "heads"),
}

_HEAD_TYPES = {
    "continuous": ContinuousHeadConfig,
    "categorical": CategoricalHeadConfig,
    "diffusion": DiffusionHeadConfig,
}


def _strip_optional(tp):
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _variant(cls, data: Dict[str, Any]):
    """``cls``, or the subclass of it whose fields hold the keys of ``data``
    that ``cls`` lacks (``LatentMoETransformerConfig`` for a transformer
    group that names its fields)."""
    extra = set(data) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        for sub in cls.__subclasses__():
            if extra <= {f.name for f in dataclasses.fields(sub)}:
                return sub
    return cls


def config_from_dict(cls, data: Dict[str, Any]):
    """Recursively build a (frozen) config dataclass from plain dicts."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    cls = _variant(cls, data)
    kwargs = {}
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise KeyError(
            f"unknown field(s) {sorted(unknown)} for {cls.__name__}; "
            f"valid: {sorted(field_names)}")
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        tp = _strip_optional(hints.get(f.name, f.type))
        if dataclasses.is_dataclass(tp) and isinstance(val, dict):
            val = config_from_dict(tp, val)
        elif typing.get_origin(tp) is tuple and isinstance(val, (list, tuple)):
            val = tuple(val)
        elif val is not None and tp in (int, float, str, bool):
            if tp is bool and not isinstance(val, bool):
                raise TypeError(
                    f"{cls.__name__}.{f.name} expects bool, got {val!r}")
            if tp is int and (isinstance(val, bool) or
                              not isinstance(val, int)):
                raise TypeError(
                    f"{cls.__name__}.{f.name} expects int, got {val!r}")
            if tp is float and not isinstance(val, (int, float)) or (
                    tp is float and isinstance(val, bool)):
                raise TypeError(
                    f"{cls.__name__}.{f.name} expects float, got {val!r}")
            if tp is str and not isinstance(val, str):
                raise TypeError(
                    f"{cls.__name__}.{f.name} expects str, got {val!r}")
        kwargs[f.name] = val
    return cls(**kwargs)


def _load_yaml(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _load_group(group: str, choice: str, config_dir: str) -> Dict[str, Any]:
    return _load_yaml(os.path.join(config_dir, group, f"{choice}.yaml"))


def _apply_override(tree: Dict[str, Any], dotted: str, value: Any):
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot override through non-dict at {k!r} "
                             f"in {dotted!r}")
    node[keys[-1]] = value


def _parse_value(text: str) -> Any:
    return yaml.safe_load(text)


def _split_override(ov: str):
    if "=" not in ov:
        raise ValueError(f"override {ov!r} must look like key=value")
    key, _, val = ov.partition("=")
    return key.strip(), val.strip()


def _override_tree(tree: Dict[str, Any], overrides: Sequence[str]):
    """Apply ``key.path=value`` overrides to the config tree, the values
    parsed as YAML."""
    for ov in overrides:
        key, val = _split_override(ov)
        _apply_override(tree, key, _parse_value(val))


_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def _resolve_interpolations(tree: Dict[str, Any], max_depth: int = 8):
    """Resolve ``${a.b.c}`` string values against the composed tree
    (OmegaConf-style interpolation, e.g. ``${dtype}``); a missing key
    raises KeyError, a cycle ValueError."""

    def lookup(dotted: str):
        node = tree
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(
                    f"interpolation ${{{dotted}}} not found in config")
            node = node[part]
        return node

    def resolve(val):
        # follow ${a} -> ${b} -> ... chains of any length, bounded so a
        # reference cycle (a: ${b}, b: ${a}) raises instead of spinning
        depth = 0
        while isinstance(val, str):
            m = _INTERP_RE.match(val.strip())
            if m is None:
                break
            if depth >= max_depth:
                raise ValueError(
                    f"interpolation depth exceeded resolving "
                    f"${{{m.group(1)}}} (cycle?)")
            val = lookup(m.group(1))
            depth += 1
        return val

    def walk(node):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, val in items:
            if isinstance(val, str):
                node[key] = resolve(val)
            elif isinstance(val, (dict, list)):
                walk(val)

    walk(tree)


def load_config(name: str,
                overrides: Optional[Sequence[str]] = None,
                config_dir: Optional[str] = None) -> OctoConfig:
    """Compose ``<config_dir>/<name>.yaml`` with its group defaults and
    apply ``key.path=value`` overrides (``group=choice`` swaps a group)."""
    config_dir = config_dir or CONFIG_DIR
    root = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults: Dict[str, str] = root.pop("defaults", {}) or {}

    # group swaps from overrides happen before group files load
    value_overrides: List[str] = []
    for ov in overrides or []:
        key, val = _split_override(ov)
        if key in _GROUPS:
            defaults[key] = val
        else:
            value_overrides.append(ov)

    # compose: group yaml -> root subtree (root keys win)
    tree: Dict[str, Any] = {}
    for group, choice in defaults.items():
        if group not in _GROUPS:
            raise ValueError(f"unknown config group {group!r}; "
                             f"valid: {sorted(_GROUPS)}")
        tree[group] = _load_group(group, choice, config_dir)
    for k, v in root.items():
        if k in tree and isinstance(v, dict):
            tree[k].update(v)
        else:
            tree[k] = v

    _override_tree(tree, value_overrides)
    _resolve_interpolations(tree)

    # heads group: {continuous: {...}, diffusion: {...}} with nulls allowed
    if isinstance(tree.get("heads"), dict):
        heads = {}
        for hname, hval in tree["heads"].items():
            if hname not in _HEAD_TYPES:
                raise ValueError(f"unknown head {hname!r}; "
                                 f"valid: {sorted(_HEAD_TYPES)}")
            heads[hname] = config_from_dict(_HEAD_TYPES[hname], hval or {})
        tree["heads"] = HeadsConfig(**heads)

    for group, (cls, field_name) in _GROUPS.items():
        if group in tree and isinstance(tree[group], dict):
            tree[field_name] = config_from_dict(cls, tree.pop(group))

    return config_from_dict(OctoConfig, tree)


def apply_overrides(cfg: OctoConfig,
                    overrides: Optional[Sequence[str]]) -> OctoConfig:
    """``cfg`` with ``key.path=value`` overrides applied as
    :func:`load_config` applies them, e.g.
    ``["dtype=bfloat16", "transformer.attention_impl=flash"]``; a group
    swap needs :func:`load_config`."""
    if not overrides:
        return cfg
    swaps = [ov for ov in overrides if _split_override(ov)[0] in _GROUPS]
    if swaps:
        raise ValueError(f"group swaps {swaps} need load_config")
    tree = dataclasses.asdict(cfg)
    _override_tree(tree, overrides)
    return config_from_dict(type(cfg), tree)
