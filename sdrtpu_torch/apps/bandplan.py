"""Band plans — ``core/src/gui/widgets/bandplan`` capability (PyTorch
counterpart of ``sdrtpu/apps/bandplan.py``; host code).

Loads SDR++-format band plan JSON ({"name", "country_code", "bands":
[{"name", "type", "start", "end"}, ...]}) and answers "which band is this
frequency in".  A small built-in general plan covers common allocations.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class Band:
    name: str
    type: str
    start: float
    end: float


# Minimal built-in plan (ITU-ish broadcast/amateur allocations).
BUILTIN_GENERAL = [
    Band("LW Broadcast", "broadcast", 148.5e3, 283.5e3),
    Band("MW Broadcast", "broadcast", 526.5e3, 1706.5e3),
    Band("80m Amateur", "amateur", 3.5e6, 4.0e6),
    Band("40m Amateur", "amateur", 7.0e6, 7.3e6),
    Band("20m Amateur", "amateur", 14.0e6, 14.35e6),
    Band("10m Amateur", "amateur", 28.0e6, 29.7e6),
    Band("6m Amateur", "amateur", 50.0e6, 54.0e6),
    Band("FM Broadcast", "broadcast", 87.5e6, 108.0e6),
    Band("Airband", "aviation", 108.0e6, 137.0e6),
    Band("2m Amateur", "amateur", 144.0e6, 148.0e6),
    Band("Marine VHF", "marine", 156.0e6, 162.025e6),
    Band("70cm Amateur", "amateur", 420.0e6, 450.0e6),
    Band("23cm Amateur", "amateur", 1240.0e6, 1300.0e6),
]


class BandPlan:
    def __init__(self, bands: list[Band] | None = None, name: str = "General"):
        self.name = name
        self.bands = sorted(bands or BUILTIN_GENERAL, key=lambda b: b.start)

    @classmethod
    def load(cls, path: str) -> "BandPlan":
        with open(path) as f:
            data = json.load(f)
        bands = [
            Band(b["name"], b.get("type", ""), float(b["start"]), float(b["end"]))
            for b in data.get("bands", [])
        ]
        return cls(bands, data.get("name", "unnamed"))

    def save(self, path: str) -> None:
        data = {
            "name": self.name,
            "country_name": "--",
            "country_code": "--",
            "author_name": "sdrtpu",
            "author_url": "",
            "bands": [
                {"name": b.name, "type": b.type, "start": b.start, "end": b.end}
                for b in self.bands
            ],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def lookup(self, freq: float) -> list[Band]:
        return [b for b in self.bands if b.start <= freq <= b.end]

    def bands_in_range(self, start: float, end: float) -> list[Band]:
        return [b for b in self.bands if b.end >= start and b.start <= end]
