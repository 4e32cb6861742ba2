"""Hydra-compatible config loading without hydra (counterpart of
``mode_diffusion_policy_tpu/config/loader.py``; plain Python, copied).

Supports the subset of Hydra 1.1 semantics the reference configs use (the
root ``conf/``): ``defaults`` lists with group composition
(``- datamodule: calvin``), absolute-path + rename entries
(``- /callbacks/rollout_lh/tasks@tasks: new_playtable_tasks``), package
self-placement, ``${a.b}`` interpolation across the merged tree,
``${now:fmt}`` timestamps, and dotted CLI overrides (``a.b=c``,
``group=option``). Configs resolve to plain nested dicts; ``_target_``
strings are mapped through config/registry.py so reference configs work
verbatim.

PyYAML is imported where a file is read or an override parsed, so the
module imports without it; reading a config then raises an ``ImportError``
that names it.
"""
from __future__ import annotations

import copy
import datetime
import re
from pathlib import Path
from typing import Dict, List, Optional, Union

_INTERP = re.compile(r"\$\{([^}]+)\}")


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _get_path(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def _set_path(tree: Dict, dotted: str, value):
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        if isinstance(node, list):
            node = node[int(p)]
        else:
            node = node.setdefault(p, {})
    if isinstance(node, list):
        node[int(parts[-1])] = value
    else:
        node[parts[-1]] = value


def require_yaml():
    """The ``yaml`` module, or an ImportError that names PyYAML."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a YAML config needs PyYAML (the "
                          "'pyyaml' package), which is not installed") from e
    return yaml


def _parse_value(text: str):
    yaml = require_yaml()
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


class ConfigLoader:
    def __init__(self, config_dir: Union[str, Path]):
        self.config_dir = Path(config_dir)

    def _read(self, rel: str) -> Dict:
        yaml = require_yaml()
        path = self.config_dir / f"{rel}.yaml"
        with open(path) as f:
            return yaml.safe_load(f) or {}

    def _compose(self, rel: str, group_prefix: str = "") -> Dict:
        """Load one config file, resolving its defaults list
        (hydra group composition)."""
        raw = self._read(rel)
        defaults = raw.pop("defaults", [])
        cfg: Dict = {}
        for entry in defaults:
            if entry == "_self_":
                cfg = _deep_merge(cfg, raw)
                raw = {}
                continue
            if isinstance(entry, str):
                sub = self._compose(f"{group_prefix}{entry}", group_prefix)
                cfg = _deep_merge(cfg, sub)
                continue
            (key, option), = entry.items()
            if option is None:
                continue
            target_key = None
            if "@" in key:
                key, target_key = key.split("@", 1)
            key = key.lstrip("/")
            if key.startswith("override "):
                key = key[len("override "):]
            # path of the option file; relative entries live under the
            # current file's directory group
            parent = str(Path(rel).parent)
            parent = "" if parent == "." else parent + "/"
            if ("/" in key) or not (self.config_dir / parent / key).is_dir():
                opt_rel = f"{key}/{option}"
            else:
                opt_rel = f"{parent}{key}/{option}"
            sub = self._compose(opt_rel, group_prefix)
            place = target_key if target_key is not None else key.split("/")[-1]
            cfg = _deep_merge(cfg, {place: sub} if place else sub)
        cfg = _deep_merge(cfg, raw)
        return cfg

    def load(self, config_name: str,
             overrides: Optional[List[str]] = None) -> Dict:
        cfg = self._compose(config_name)
        for ov in overrides or []:
            if "=" not in ov:
                raise ValueError(f"override must be key=value: {ov}")
            key, value = ov.split("=", 1)
            key = key.lstrip("+")
            # group override: datamodule=libero loads conf/datamodule/libero
            if (self.config_dir / key).is_dir():
                cfg[key] = self._compose(f"{key}/{value}")
            else:
                _set_path(cfg, key, _parse_value(value))
        return resolve_interpolations(cfg)


def resolve_interpolations(cfg: Dict, max_passes: int = 10) -> Dict:
    """Resolve ${a.b} and ${now:...} against the root of the tree."""
    root = copy.deepcopy(cfg)

    def resolve_str(s: str):
        full = _INTERP.fullmatch(s.strip())
        if full:
            expr = full.group(1)
            return resolve_expr(expr, s)
        def repl(m):
            v = resolve_expr(m.group(1), None)
            return str(v)
        return _INTERP.sub(repl, s)

    def resolve_expr(expr: str, fallback):
        if expr.startswith("now:"):
            fmt = expr[4:]
            return datetime.datetime.now().strftime(fmt)
        try:
            return _get_path(root, expr)
        except KeyError:
            return fallback if fallback is not None else "${" + expr + "}"

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    for _ in range(max_passes):
        new = walk(root)
        if new == root:
            break
        root = new
    return root


def load_config(config_dir, config_name, overrides=None) -> Dict:
    return ConfigLoader(config_dir).load(config_name, overrides)
