"""Hydra-compatible configuration engine for the port.

Copy of ``dfot_tpu/config.py`` (``Config`` :57, ``compose`` :340,
``unwrap_shortcuts`` :310, ``load_config`` :452) with PyYAML replaced by the
port's reader of the repository's YAML subset (``utils/yaml_reader.py``):
the machine with the card has no PyYAML. The semantics are the JAX
package's, which mirror the reference CLI surface:

- a root ``config.yaml`` with a ``defaults:`` list composing config *groups*
  (``experiment/``, ``dataset/``, ``algorithm/``, ``algorithm/backbone/``, ...),
- nested defaults inside group files,
- the optional ``dataset_experiment/${dataset}_${experiment}.yaml`` overlay with
  ``# @package _global_`` semantics,
- ``${a.b.c}`` interpolation (resolved lazily, late overrides win),
- CLI overrides: ``key=value``, ``+key=value`` (append), ``++key=value``
  (force), group re-selection ``algorithm/backbone=u_vit3d``,
- ``@shortcut/path`` macros expanded to ``++key=value`` overrides *before*
  composition.

Values on the command line are read as YAML scalars (``parse_scalar``);
text outside the reader's subset raises rather than being read as a string.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from .utils.yaml_reader import dump_flow, load as _yaml_text, parse_scalar

__all__ = ["Config", "load_config", "compose", "unwrap_shortcuts"]

_MISSING = object()
# the repository's config tree, beside this package
CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configurations"
)
_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config:
    """A nested attribute-accessible config node (OmegaConf DictConfig-alike).

    Interpolations (``${a.b}``) are resolved at *access* time against the root
    node, so values overridden after composition are reflected everywhere.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: Dict[str, Any], root: Optional["Config"] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root)

    def __reduce__(self):
        # by value, for worker processes (``__getattr__`` would answer pickle's
        # probes for ``__setstate__`` on an instance without its slots)
        return (Config, (self._data, self._root))

    # -- core access ------------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        root = self._root if self._root is not None else self
        if isinstance(value, dict):
            return Config(value, root)
        if isinstance(value, str):
            return _resolve_str(value, root)
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def __getattr__(self, key: str) -> Any:
        try:
            return self._wrap(self._data[key])
        except KeyError:
            raise AttributeError(key) from None

    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._wrap(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self._wrap(v) for v in self._data.values()]

    def items(self):
        return [(k, self._wrap(v)) for k, v in self._data.items()]

    def pop(self, key: str, default: Any = _MISSING) -> Any:
        if default is _MISSING:
            return self._wrap(self._data.pop(key))
        return self._wrap(self._data.pop(key, _unwrap(default)))

    def setdefault(self, key: str, value: Any) -> Any:
        return self._wrap(self._data.setdefault(key, _unwrap(value)))

    # -- utilities ----------------------------------------------------------
    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch ``a.b.c`` with a default (OmegaConf.select equivalent)."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                return default
        return node

    def update(self, dotted: str, value: Any) -> None:
        """Set ``a.b.c = value``, creating intermediate dicts."""
        parts = dotted.split(".")
        node = self._data
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = _unwrap(value)

    def to_dict(self, resolve: bool = False) -> Dict[str, Any]:
        """Plain-dict copy; optionally resolve all interpolations."""
        if not resolve:
            return copy.deepcopy(self._data)
        return _resolve_container(copy.deepcopy(self._data), self._root or self)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self._data))

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value._data
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    if isinstance(value, tuple):
        return [_unwrap(v) for v in value]
    return value


def _resolve_str(value: str, root: Config) -> Any:
    """Resolve ``${...}`` interpolations in a string against the root config."""
    m = _INTERP_RE.fullmatch(value.strip())
    if m:  # whole-string interpolation: preserve the referenced value's type
        ref = root.select(m.group(1), _MISSING)
        if ref is _MISSING:
            return value
        return ref

    def sub(match: re.Match) -> str:
        ref = root.select(match.group(1), _MISSING)
        return value if ref is _MISSING else str(_unwrap(ref))

    if "${" in value:
        out = _INTERP_RE.sub(sub, value)
        # repeat for nested interpolation results
        if "${" in out and out != value:
            return _resolve_str(out, root)
        return out
    return value


def _resolve_container(node: Any, root: Config) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_container(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_container(v, root) for v in node]
    if isinstance(node, str):
        out = _resolve_str(node, root)
        return _unwrap(out) if isinstance(out, Config) else _unwrap(out)
    return node


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``overlay`` into ``base`` (overlay wins; dicts merge recursively)."""
    for key, value in overlay.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _load_yaml(path: str) -> Tuple[Dict[str, Any], bool]:
    """Load a YAML file; returns (data, is_global_package)."""
    with open(path, "r") as f:
        text = f.read()
    is_global = bool(re.search(r"^#\s*@package\s+_global_\s*$", text, re.M))
    data = _yaml_text(text, path) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping")
    return data, is_global


def _compose_group_file(
    config_dir: str,
    group: str,
    name: str,
    choices: Dict[str, str],
    group_overrides: Dict[str, str],
) -> Dict[str, Any]:
    """Compose a single group file, processing its own ``defaults`` list.

    ``group`` is the group path relative to config_dir ('' for root).
    """
    path = os.path.join(config_dir, group, f"{name}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Config group file not found: {path} (group={group!r}, name={name!r})"
        )
    data, _ = _load_yaml(path)
    defaults = data.pop("defaults", [])
    # outermost selection wins: nested same-group includes (e.g. kinetics_600
    # -> base_video -> base_dataset) must not clobber the user's choice
    choices.setdefault(group or "root", name)

    merged: Dict[str, Any] = {}
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(merged, data)
            data = {}
            continue
        if isinstance(entry, str):
            # same-group include, merged at this node's root
            sub = _compose_group_file(config_dir, group, entry, choices, group_overrides)
            _deep_merge(merged, sub)
            continue
        if isinstance(entry, dict):
            (key, value), = entry.items()
            optional = False
            if isinstance(key, str) and key.startswith("optional "):
                optional = True
                key = key[len("optional "):]
            if value is None:
                continue
            child_group = f"{group}/{key}" if group else key
            # CLI group override (e.g. algorithm/backbone=u_vit3d) wins
            value = group_overrides.get(child_group, value)
            try:
                sub = _compose_group_file(
                    config_dir, child_group, str(value), choices, group_overrides
                )
            except FileNotFoundError:
                if optional:
                    continue
                raise
            node = merged.setdefault(key, {})
            if not isinstance(node, dict):
                merged[key] = {}
                node = merged[key]
            _deep_merge(node, sub)
            continue
        raise ValueError(f"Unsupported defaults entry {entry!r} in {path}")
    _deep_merge(merged, data)
    return merged


def unwrap_shortcuts(overrides: List[str], config_dir: str) -> List[str]:
    """Expand ``@shortcut/path`` macros into ``++key=value`` overrides.

    Mirrors reference utils/hydra_utils.py:43-96: each ``@name`` argument reads
    ``configurations/shortcut/{name}.yaml`` and flattens its mapping to forced
    overrides inserted in place.
    """
    out: List[str] = []
    for arg in overrides:
        if not arg.startswith("@"):
            out.append(arg)
            continue
        path = os.path.join(config_dir, "shortcut", arg[1:] + ".yaml")
        data, _ = _load_yaml(path)

        def flatten(node: Dict[str, Any], prefix: str = "") -> None:
            for k, v in node.items():
                dotted = f"{prefix}{k}"
                if isinstance(v, dict):
                    flatten(v, dotted + ".")
                else:
                    out.append(f"++{dotted}={dump_flow(v)}")

        flatten(data)
    return out


def compose(
    config_dir: str,
    overrides: Optional[List[str]] = None,
    config_name: str = "config",
) -> Config:
    """Compose the full config like ``python -m main`` does in the reference.

    Override grammar:
      - ``group=name`` re-selects a top-level group in the root defaults list
        (``experiment=``, ``dataset=``, ``algorithm=``, ``cluster=``)
      - ``group/sub=name`` re-selects a nested group (``algorithm/backbone=``)
      - ``key.sub=value`` sets a value (must exist unless prefixed with +/++)
      - ``+key=value`` adds a new key; ``++key=value`` adds or overrides
      - ``@shortcut/name`` expands macros (see :func:`unwrap_shortcuts`)
    """
    overrides = unwrap_shortcuts(list(overrides or []), config_dir)

    root_path = os.path.join(config_dir, f"{config_name}.yaml")
    root_data, _ = _load_yaml(root_path)
    defaults = root_data.pop("defaults", [])

    # split overrides into group selections and value overrides
    group_overrides: Dict[str, str] = {}
    value_overrides: List[Tuple[str, str, bool]] = []  # (key, raw_value, forced)
    for arg in overrides:
        forced = arg.startswith("++")
        added = arg.startswith("+") and not forced
        body = arg.lstrip("+")
        if "=" not in body:
            raise ValueError(f"Malformed override {arg!r} (expected key=value)")
        key, raw = body.split("=", 1)
        if "/" in key and not forced and not added:
            group_overrides[key] = raw
        elif not forced and not added and re.fullmatch(r"[A-Za-z_][\w]*", key) and _is_group(
            config_dir, key
        ):
            group_overrides[key] = raw
        else:
            value_overrides.append((key, raw, forced or added))

    choices: Dict[str, str] = {}
    composed: Dict[str, Any] = {}
    deferred_overlays: List[Tuple[str, str]] = []  # (group, name-template)

    for entry in defaults:
        if entry == "_self_":
            _deep_merge(composed, root_data)
            root_data = {}
            continue
        (key, value), = entry.items() if isinstance(entry, dict) else ((entry, None),)
        optional = False
        if isinstance(key, str) and key.startswith("optional "):
            optional = True
            key = key[len("optional "):]
        if key in group_overrides:
            value = group_overrides[key]
            if value in ("null", "None", ""):
                value = None
        if value is None:
            choices[key] = None
            continue
        if "${" in str(value):
            # e.g. dataset_experiment: ${dataset}_${experiment} — resolve after
            deferred_overlays.append((key, str(value)))
            continue
        sub = _compose_group_file(config_dir, key, str(value), choices, group_overrides)
        node = composed.setdefault(key, {})
        _deep_merge(node, sub)
    _deep_merge(composed, root_data)

    # resolve deferred overlays (dataset_experiment) against runtime choices
    for group, template in deferred_overlays:
        name = re.sub(r"\$\{(\w+)\}", lambda m: str(choices.get(m.group(1), "")), template)
        path = os.path.join(config_dir, group, f"{name}.yaml")
        if not os.path.exists(path):
            continue
        data, is_global = _load_yaml(path)
        data.pop("defaults", None)
        choices[group] = name
        if is_global:
            _deep_merge(composed, data)
        else:
            _deep_merge(composed.setdefault(group, {}), data)

    cfg = Config(composed)

    # inject hydra runtime-choice names (reference main.py:51-57)
    for group, name in choices.items():
        if name is None or group == "root":
            continue
        node = cfg.select(group.replace("/", "."))
        if isinstance(node, Config) and "_name" not in node:
            node["_name"] = name
    cfg["_choices"] = {k: v for k, v in choices.items() if k != "root"}

    # apply value overrides last
    for key, raw, allow_new in value_overrides:
        value = parse_scalar(raw)
        if not allow_new and cfg.select(key, _MISSING) is _MISSING:
            raise KeyError(
                f"Override key {key!r} not found in composed config "
                f"(prefix with + or ++ to add new keys)"
            )
        cfg.update(key, value)

    return cfg


def _is_group(config_dir: str, name: str) -> bool:
    return os.path.isdir(os.path.join(config_dir, name))


def load_config(
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> Config:
    """Load the framework config from the repo's ``configurations/`` tree."""
    if config_dir is None:
        config_dir = CONFIG_DIR
    return compose(config_dir, overrides)
