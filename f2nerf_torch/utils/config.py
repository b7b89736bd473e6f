"""Hydra-compatible config composition without the hydra dependency.

The reference drives everything through hydra configs (`confs/*.yaml` with a
`defaults` list over groups train/dataset/renderer/pts_sampler/field/shader,
plus dotted CLI overrides; see reference scripts/run.py:37-77). hydra is not
available in this environment, so this module implements the subset of
composition semantics those configs use:

  * a top-level yaml with a ``defaults`` list of ``{group: name}`` entries and
    ``_self_`` marking where the file's own keys merge in;
  * group yamls loaded into ``cfg[group]``;
  * CLI overrides ``a.b=c`` (must exist) and ``+a.b=c`` (may create).

Values are parsed with yaml so ``mode=train`` gives a str and
``dataset.factor=4`` gives an int, matching hydra behavior.

Copy of ``f2nerf_tpu/utils/config.py`` (that package imports jax; the port
does not); tests/test_torch_ops.py holds the two composers equal.
"""

from __future__ import annotations

import copy
import os
from typing import Any

import re

import yaml


class _SciLoader(yaml.SafeLoader):
    """SafeLoader that parses '1e-3'-style floats (pyyaml's yaml-1.1 resolver
    requires a decimal point before the exponent; hydra/yaml-cpp do not)."""


_SciLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
                   |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
                   |\.[0-9_]+(?:[eE][-+][0-9]+)?
                   |[-+]?\.(?:inf|Inf|INF)
                   |\.(?:nan|NaN|NAN))$""", re.X),
    list("-+0123456789."),
)


def _yaml_load(stream):
    return yaml.load(stream, Loader=_SciLoader)


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return _yaml_load(f) or {}


def compose(config_dir: str, config_name: str, overrides: list[str] | None = None) -> dict:
    """Compose ``confs/<config_name>.yaml`` the way hydra would."""
    top_path = os.path.join(config_dir, config_name + ".yaml")
    top = load_yaml(top_path)
    defaults = top.pop("defaults", [])

    cfg: dict[str, Any] = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(cfg, top)
            self_merged = True
            continue
        if isinstance(entry, dict):
            (group, name), = entry.items()
            group_cfg = load_yaml(os.path.join(config_dir, str(group), str(name) + ".yaml"))
            _deep_merge(cfg, {str(group): group_cfg})
        else:
            _deep_merge(cfg, load_yaml(os.path.join(config_dir, str(entry) + ".yaml")))
    if not self_merged:
        _deep_merge(cfg, top)

    for ov in overrides or []:
        apply_override(cfg, ov)
    return cfg


def apply_override(cfg: dict, override: str) -> None:
    allow_new = override.startswith("+")
    if allow_new:
        override = override[1:]
    if "=" not in override:
        raise ValueError(f"Malformed override (expected key=value): {override!r}")
    key, raw_val = override.split("=", 1)
    val = _yaml_load(raw_val) if raw_val != "" else None
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node:
            if not allow_new:
                raise KeyError(f"Override key {key!r} not in config (use +{key}=... to add)")
            node[p] = {}
        node = node[p]
    if parts[-1] not in node and not allow_new:
        raise KeyError(f"Override key {key!r} not in config (use +{key}=... to add)")
    node[parts[-1]] = val


def save(cfg: dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


class Cfg:
    """Read-only attribute/key access wrapper with .get() defaults."""

    def __init__(self, d: dict):
        self._d = d

    def __getitem__(self, k):
        v = self._d[k]
        return Cfg(v) if isinstance(v, dict) else v

    def __contains__(self, k):
        return k in self._d

    def get(self, k, default=None):
        v = self._d.get(k, default)
        return Cfg(v) if isinstance(v, dict) else v

    def to_dict(self) -> dict:
        return copy.deepcopy(self._d)
