"""Config system: YAML with recursive ``_BASE_CONFIG_`` inheritance.

The port's own copy of the attribute-style config (``EDict``) and the YAML
loader with ``_BASE_CONFIG_`` resolution (reference semantics,
``pcdet/config.py:51-85``). It reads the same ``tools/cfgs/**`` files as the
JAX package.
"""
from __future__ import annotations

import copy
from pathlib import Path

import yaml

ROOT_DIR = Path(__file__).resolve().parent.parent


class EDict(dict):
    """Attribute-accessible dict (recursive)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __deepcopy__(self, memo):
        return EDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _resolve_base(path: str) -> Path:
    """A ``_BASE_CONFIG_`` path as given, else relative to the repo root or
    its ``tools/`` directory (the reference configs are written relative to
    ``tools/``)."""
    for cand in (Path(path), ROOT_DIR / path, ROOT_DIR / 'tools' / path):
        if cand.exists():
            return cand
    raise FileNotFoundError(f'_BASE_CONFIG_ not found: {path}')


def merge_new_config(config: EDict, new_config: dict) -> EDict:
    """Recursively merge ``new_config`` into ``config``; a ``_BASE_CONFIG_``
    key is loaded first so its sibling keys override the base."""
    if '_BASE_CONFIG_' in new_config:
        with open(_resolve_base(new_config['_BASE_CONFIG_'])) as f:
            config.update(EDict(yaml.safe_load(f)))
    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = EDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: EDict | None = None) -> EDict:
    """Load ``cfg_file`` into ``config`` (a new ``EDict`` when None)."""
    if config is None:
        config = EDict()
    with open(cfg_file) as f:
        merge_new_config(config, yaml.safe_load(f))
    return config
