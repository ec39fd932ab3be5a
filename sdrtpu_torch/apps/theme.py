"""Theme manager: SDR++-format JSON UI themes (PyTorch counterpart of
``sdrtpu/apps/theme.py``; host code).

Parity with ``ThemeManager`` (reference ``core/src/gui/theme_manager.cpp``,
``theme_manager.h``): themes are JSON objects with a required ``name``, an
optional ``author``, and color entries ``"Key": "#RRGGBBAA"``.  The
reference validates each key against its ImGui color-id table and rejects
malformed hex strings (``theme_manager.cpp:83-118`` decode loop); it applies
themes by writing the decoded RGBA into the ImGui style array.

Here there is no ImGui: a theme resolves to a plain ``{key: (r, g, b, a)}``
float dict (0..1) that any rendering front end (web view, PNG export,
matplotlib) can consume.  ``WaterfallText``/``FFTHoldColor``-class keys are
also used by `apps/waterfall.py`'s PNG export for annotation colors.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field

_HEX_RE = re.compile(r"#[0-9A-Fa-f]{8}")


def decode_color(s: str) -> tuple[float, float, float, float]:
    """'#RRGGBBAA' -> (r, g, b, a) floats in [0, 1].

    Same wire format as the reference's decode loop
    (``theme_manager.cpp:97-118``).
    """
    if not _HEX_RE.fullmatch(s):  # fullmatch: '$' would admit '...\n'
        raise ValueError(f"invalid theme color {s!r} (expected #RRGGBBAA)")
    v = int(s[1:], 16)
    return tuple(((v >> sh) & 0xFF) / 255.0 for sh in (24, 16, 8, 0))


@dataclass
class Theme:
    name: str
    author: str = "--"
    colors: dict[str, tuple[float, float, float, float]] = field(
        default_factory=dict
    )


class ThemeManager:
    """Load and look up themes from a directory of SDR++ theme JSONs."""

    def __init__(self):
        self.themes: dict[str, Theme] = {}

    def load_themes_from_dir(self, path: str) -> int:
        """Load every ``*.json`` in ``path``; returns number loaded.

        Mirrors ``ThemeManager::loadThemesFromDir``
        (``theme_manager.cpp:8-38``): the registry is cleared first (the
        call is a refresh, re-runnable), non-JSON files are skipped, and a
        bad file is logged and skipped rather than aborting the scan.
        """
        self.themes.clear()
        n = 0
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".json"):
                continue
            try:
                self.load_theme(os.path.join(path, fn))
                n += 1
            except (ValueError, OSError, json.JSONDecodeError) as e:
                logging.getLogger(__name__).error(
                    "skipping theme %s: %s", fn, e
                )
        return n

    def load_theme(self, path: str) -> Theme:
        with open(path) as f:
            data = json.load(f)
        name = data.get("name")
        if not isinstance(name, str):
            raise ValueError(f"theme {path} missing string 'name'")
        if name in self.themes:
            raise ValueError(f"a theme named {name!r} already exists")
        thm = Theme(name=name)
        author = data.get("author")
        if author is not None:
            if not isinstance(author, str):
                raise ValueError(f"theme {path}: 'author' must be a string")
            thm.author = author
        for key, val in data.items():
            if key in ("name", "author"):
                continue
            if not isinstance(val, str):
                raise ValueError(f"theme {path}: {key} must be a color string")
            thm.colors[key] = decode_color(val)
        self.themes[name] = thm
        return thm

    def apply(self, name: str) -> Theme:
        """Select a theme by name (``ThemeManager::applyTheme``)."""
        if name not in self.themes:
            raise KeyError(f"unknown theme {name!r}")
        return self.themes[name]

    def get_theme_names(self) -> list[str]:
        return list(self.themes)
