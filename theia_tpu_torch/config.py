"""Minimal hydra-style config system (port of theia_tpu/config.py): YAML groups + defaults + CLI overrides.

The reference uses Hydra/OmegaConf (reference:
src/theia/scripts/train/train_rvfm.py:332; src/theia/configs/) which aren't
in this image; this module reproduces the semantics the reference relies on:

- a root config with a ``defaults`` list composing group configs
  (``- model/backbone: deit`` loads configs/model/backbone/deit.yaml into
  cfg.model.backbone);
- group configs may have their own ``defaults`` relative to their group dir
  (training/frame_level.yaml pulls ``target_models: cdiv``);
- CLI overrides: ``a.b.c=value`` (values YAML-parsed) and group swaps
  ``model/backbone=deit_reg``.

The port reads its own copy of the YAML tree (``theia_tpu_torch/configs/``),
never the JAX package's files.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional

import yaml


class DotDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o: Any) -> Any:
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


DEFAULT_CONFIG_PATH = os.path.join(os.path.dirname(__file__), "configs")


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _load_group(config_path: str, group: str, name: str) -> dict:
    """Load a group config (with its own relative defaults) into a dict."""
    path = os.path.join(config_path, group, f"{name}.yaml")
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", [])
    merged: dict = {}
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, raw)
            raw = {}
            continue
        if isinstance(entry, dict):
            ((sub, subname),) = entry.items()
        else:
            sub, subname = entry, None
        if subname is None:
            # bare entry: sibling config in the same group dir
            merged = _deep_merge(merged, _load_group(config_path, group, str(sub)))
        else:
            sub_group = os.path.join(group, str(sub))
            sub_cfg = _load_group(config_path, sub_group, str(subname))
            node = merged.setdefault(str(sub), {})
            merged[str(sub)] = _deep_merge(node, sub_cfg)
    return _deep_merge(merged, raw)


def load_config(
    config_name: str,
    overrides: Optional[Iterable[str]] = None,
    config_path: str = DEFAULT_CONFIG_PATH,
) -> DotDict:
    """Compose the root config with its defaults, then apply CLI overrides."""
    root_raw = _load_yaml(os.path.join(config_path, f"{config_name}.yaml"))
    defaults = root_raw.pop("defaults", [])
    group_choices: dict[str, str] = {}
    order: list[str] = []
    self_pos = len(defaults)
    for i, entry in enumerate(defaults):
        if entry == "_self_":
            self_pos = i
            continue
        ((group, name),) = entry.items() if isinstance(entry, dict) else ((entry, None),)
        group = str(group)
        group_choices[group] = str(name)
        order.append(group)

    # group swaps from overrides (e.g. model/backbone=deit_reg)
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        if "/" in key or (key in group_choices and "." not in key):
            group_choices[key] = val
            if key not in order:
                order.append(key)
        else:
            value_overrides.append((key, yaml.safe_load(val)))

    cfg: dict = {}
    for group in order:
        name = group_choices[group]
        sub_cfg = _load_group(config_path, group, name)
        node = cfg
        for part in group.split("/"):
            node = node.setdefault(part, {})
        node.update(_deep_merge(node, sub_cfg))
    cfg = _deep_merge(cfg, root_raw)

    for key, val in value_overrides:
        _set_dotted(cfg, key, val)
    return DotDict.wrap(cfg)


def to_yaml(cfg: DotDict) -> str:
    return yaml.safe_dump(cfg.to_dict(), sort_keys=False)
