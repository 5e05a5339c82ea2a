"""Hierarchical YAML config system (copy of clip_fsar_tpu/config/config.py:37-236; both packages
read the same ``configs/`` tree).

Behavior-compatible with the reference config loader
(utils/config.py:16-265) so the shipped CLIP-FSAR project
YAMLs keep working:

  * a global defaults file ``configs/pool/base.yaml`` is loaded first;
  * a config may name parents via ``_BASE`` (full override chain) or
    ``_BASE_RUN`` / ``_BASE_MODEL`` (run preset merged with
    ``preserve_base`` semantics, model preset merged normally);
  * child values override parent values, recursively for dicts;
  * command-line overrides are ``KEY.SUBKEY value`` pairs;
  * scientific-notation strings like ``"5e-5"`` coerce to float (the
    reference coerces at utils/config.py:246-247 — absence of this breaks
    ``SOLVER.WEIGHT_DECAY: 5e-5`` read back from CLI);
  * **absence of a key is meaningful**: the reference gates features with
    ``hasattr(cfg.TRAIN, "FLAG")`` (e.g. few_shot.py:2736).  ``Config``
    therefore raises AttributeError for missing keys and supports
    ``hasattr`` / ``cfg.get(key, default)`` tri-state logic.

The implementation is a fresh design: a thin immutable-ish attribute tree
over plain nested dicts, plus pure functions for merging.  No torch, no
global state.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Any, Dict, List, Optional

import yaml

_BASE_KEYS = ("_BASE", "_BASE_RUN", "_BASE_MODEL")


def _coerce(value: Any) -> Any:
    """Coerce scientific-notation strings to float (reference quirk)."""
    if isinstance(value, str) and len(value) >= 3 and value[1:3] == "e-":
        try:
            return float(value)
        except ValueError:
            return value
    return value


class Config:
    """Attribute-access view over a nested dict.

    ``cfg.TRAIN.WAY`` style access; missing keys raise AttributeError so
    ``hasattr`` gating works exactly like the reference.
    """

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if cfg_dict:
            for k, v in cfg_dict.items():
                self._data[k] = Config(v) if isinstance(v, dict) else _coerce(v)

    # -- mapping-ish interface -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = Config(value) if isinstance(value, dict) else value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        setattr(self, name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    # -- helpers ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def deep_copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def dump(self, path: Optional[str] = None) -> str:
        """Serialize to YAML; if ``path`` given, also write a file."""
        text = yaml.safe_dump(self.to_dict(), sort_keys=False)
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        return text

    def __repr__(self) -> str:
        return "Config(" + json.dumps(self.to_dict(), default=str)[:200] + "...)"


# -- pure merge functions --------------------------------------------------------


def merge_into(base: Dict[str, Any], new: Dict[str, Any], preserve_base: bool = False) -> Dict[str, Any]:
    """Merge ``new`` into ``base`` (in place), child wins.

    ``preserve_base=True`` reproduces the reference's ``_BASE_RUN`` handling
    (utils/config.py:154-175): keys containing "BASE" are only propagated
    from the child when preserve_base is set.
    """
    for k, v in new.items():
        if k in base:
            if isinstance(v, dict) and isinstance(base[k], dict):
                merge_into(base[k], v)
            else:
                base[k] = v
        else:
            if "BASE" not in k or preserve_base:
                base[k] = v
    return base


def _resolve_parent_path(ref: str, current_file: str, top_file: str) -> str:
    """Resolve a ``_BASE``-style reference.

    ``../x.yaml`` / ``../../x.yaml`` are relative to the directory of the
    file that contains the reference; ``./x.yaml`` is relative to the
    directory of the *top-level* config (reference quirk,
    utils/config.py:118-125).
    """
    if ref.startswith("./"):
        return os.path.normpath(os.path.join(os.path.dirname(top_file), ref[2:]))
    return os.path.normpath(os.path.join(os.path.dirname(current_file), ref))


def _load_yaml_tree(path: str, top_file: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        cfg = yaml.safe_load(f.read()) or {}

    if not any(k in cfg for k in _BASE_KEYS):
        return cfg

    if "_BASE" in cfg:
        parent_path = _resolve_parent_path(cfg["_BASE"], path, top_file)
        parent = _load_yaml_tree(parent_path, top_file)
        cfg = merge_into(parent, cfg)
    else:
        if "_BASE_RUN" in cfg:
            parent_path = _resolve_parent_path(cfg["_BASE_RUN"], path, top_file)
            parent = _load_yaml_tree(parent_path, top_file)
            cfg = merge_into(parent, cfg, preserve_base=True)
        if "_BASE_MODEL" in cfg:
            parent_path = _resolve_parent_path(cfg["_BASE_MODEL"], path, top_file)
            parent = _load_yaml_tree(parent_path, top_file)
            cfg = merge_into(parent, cfg)
    return cfg


def _find_pool_base(cfg_file: Optional[str]) -> Optional[str]:
    """Locate configs/pool/base.yaml: next to cwd, the repo root, or walking
    up from the config file."""
    candidates = [os.path.join(os.getcwd(), "configs", "pool", "base.yaml")]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(here, "configs", "pool", "base.yaml"))
    if cfg_file:
        d = os.path.dirname(os.path.abspath(cfg_file))
        while d and d != os.path.dirname(d):
            candidates.append(os.path.join(d, "configs", "pool", "base.yaml"))
            d = os.path.dirname(d)
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def apply_overrides(cfg: Dict[str, Any], opts: List[str], strict: bool = True) -> Dict[str, Any]:
    """Apply ``KEY.SUBKEY value`` pairs from argv (reference
    utils/config.py:177-232; max depth 4, keys must already exist)."""
    if len(opts) % 2 != 0:
        raise ValueError(f"Override list has odd length: {opts}")
    for key, raw in zip(opts[0::2], opts[1::2]):
        parts = key.split(".")
        if len(parts) > 4:
            raise ValueError(f"Override key too deep (max 4): {key}")
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                if strict:
                    raise KeyError(f"Non-existent config key: {key}")
                node[p] = {}
            node = node[p]
        if strict and parts[-1] not in node:
            raise KeyError(f"Non-existent config key: {key}")
        try:
            value = yaml.safe_load(raw)
        except yaml.YAMLError:
            value = raw
        node[parts[-1]] = _coerce(value)
    return cfg


def load_config(cfg_file: str, opts: Optional[List[str]] = None, strict_overrides: bool = True) -> Config:
    """Load a project config: pool/base.yaml defaults <- inheritance chain
    <- CLI overrides."""
    pool_base = _find_pool_base(cfg_file)
    merged: Dict[str, Any] = {}
    if pool_base is not None:
        with open(pool_base) as f:
            merged = yaml.safe_load(f.read()) or {}
    tree = _load_yaml_tree(os.path.abspath(cfg_file), os.path.abspath(cfg_file))
    merged = merge_into(merged, tree)
    if opts:
        merged = apply_overrides(merged, list(opts), strict=strict_overrides)
    return Config(merged)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="clip_fsar_torch runner")
    parser.add_argument("--cfg", dest="cfg_file", type=str, required=True, help="path to the config yaml")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the run computes: the card (default; fails without one) or the CPU")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY.SUBKEY value override pairs")
    return parser.parse_args(argv)
