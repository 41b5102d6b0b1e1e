"""Two-layer YAML config system (port copy of ``copenerf_tpu/config/loader.py``).

Scene config files are recursively merged over the packaged
``defaults.yaml`` (a copy of the JAX package's): scalar values in the scene
file override defaults; nested dicts merge key-by-key.
"""

from __future__ import annotations

import copy
import os

import yaml

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "defaults.yaml")


def merge_recursive(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into ``base`` (in place) and return it."""
    for key, value in override.items():
        if key not in base:
            base[key] = {}
        if isinstance(value, dict):
            if not isinstance(base[key], dict):
                base[key] = {}
            merge_recursive(base[key], value)
        else:
            base[key] = value
    return base


def load_config(path: str | None, default_path: str | None = None) -> dict:
    """Load a scene config merged over the defaults.

    Args:
      path: scene YAML path, or None for pure defaults.
      default_path: alternative defaults file (defaults to the packaged one).
    """
    default_path = default_path or _DEFAULT_PATH
    with open(default_path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if path is not None:
        with open(path, "r") as f:
            scene_cfg = yaml.safe_load(f) or {}
        merge_recursive(cfg, scene_cfg)
    return cfg


def default_config() -> dict:
    """A deep copy of the packaged defaults."""
    return copy.deepcopy(load_config(None))
