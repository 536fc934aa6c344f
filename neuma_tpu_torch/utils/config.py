"""YAML config with attribute access and dotted ``--set`` overrides.

Counterpart of ``neuma_tpu/utils/config.py`` (``Config``,
``load_config``, ``Config.save``), the same code: a ``dict`` with
attribute access, ``key.path=value`` overrides parsed by
``yaml.safe_load``, and ``Config.save`` as ``yaml.safe_dump``.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, List, Optional

import yaml


class Config(dict):
    """dict with attribute access, recursive wrapping, and dotted paths."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = self._wrap(_parse_value(value))

    def merge(self, other: dict) -> "Config":
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], Config)
                and isinstance(v, dict)
            ):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [
                    x.to_dict() if isinstance(x, Config) else x for x in v
                ]
            else:
                out[k] = v
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _parse_value(v):
    """Parse CLI string values into python types."""
    if not isinstance(v, str):
        return v
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def load_config(path, overrides: Optional[List[str]] = None) -> Config:
    """Load YAML; apply ``key.path=value`` overrides."""
    path = Path(path)
    if not path.is_file():
        raise SystemExit(f"error: config file not found: {path}")
    with open(path) as f:
        cfg = Config(yaml.safe_load(f))
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        cfg.set_path(key.strip(), value.strip())
    return cfg
