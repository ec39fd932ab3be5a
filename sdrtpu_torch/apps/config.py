"""JSON configuration with default-merge, ConfigManager parity.

Mirrors ``core/src/config.{h,cpp}``: load a JSON file, recursively merge in
defaults for missing keys (``ConfigManager::load`` repair behavior,
``core.cpp:106-359``), save back.  No autosave thread — saves are explicit
(the functional framework has no background mutation to flush).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any


def merge_defaults(conf: dict, defaults: dict) -> tuple[dict, bool]:
    """Recursively add missing keys from defaults. Returns (conf, changed).

    Inserted containers are DEEP COPIES: the loaded config is mutable
    application state, and writing through a by-reference default would
    corrupt the shared defaults object (and every later repair from it).
    """
    changed = False
    for k, v in defaults.items():
        if k not in conf:
            conf[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
            changed = True
        elif isinstance(v, dict) and isinstance(conf[k], dict):
            _, ch = merge_defaults(conf[k], v)
            changed = changed or ch
    return conf, changed


class ConfigManager:
    def __init__(self, path: str, defaults: dict | None = None):
        self.path = path
        self.defaults = defaults or {}
        self.conf: dict[str, Any] = {}

    def load(self, save_if_changed: bool = True) -> dict:
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.conf = json.load(f)
            except (json.JSONDecodeError, OSError):
                self.conf = {}
        else:
            self.conf = {}
        _, changed = merge_defaults(self.conf, self.defaults)
        if changed and save_if_changed:
            self.save()
        return self.conf

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.conf, f, indent=2)
