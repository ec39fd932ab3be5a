"""Frequency manager — ``misc_modules/frequency_manager`` capability
(PyTorch counterpart of ``sdrtpu/apps/frequency_manager.py``; host
code).

Named bookmark lists with JSON persistence and SDR++-compatible
import/export shape: {"bookmarks": {name: {frequency, bandwidth, mode}}}.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass


@dataclass
class Bookmark:
    frequency: float
    bandwidth: float = 12500.0
    mode: str = "nfm"


class FrequencyManager:
    def __init__(self, path: str | None = None):
        self.path = path
        self.lists: dict[str, dict[str, Bookmark]] = {}
        if path and os.path.exists(path):
            self.load(path)

    def add(self, list_name: str, name: str, bm: Bookmark) -> None:
        self.lists.setdefault(list_name, {})[name] = bm

    def remove(self, list_name: str, name: str) -> None:
        self.lists.get(list_name, {}).pop(name, None)

    def get(self, list_name: str, name: str) -> Bookmark | None:
        return self.lists.get(list_name, {}).get(name)

    def apply(self, list_name: str, name: str, receiver_tune) -> None:
        """Tune a receiver callback to a bookmark (apply-to-VFO parity)."""
        bm = self.get(list_name, name)
        if bm:
            receiver_tune(bm.frequency, bm.mode, bm.bandwidth)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        data = {
            ln: {"bookmarks": {n: asdict(b) for n, b in lst.items()}}
            for ln, lst in self.lists.items()
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def load(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        for ln, lst in data.items():
            for n, b in lst.get("bookmarks", {}).items():
                self.add(ln, n, Bookmark(**b))

    def export_list(self, list_name: str, path: str) -> None:
        data = {
            "bookmarks": {
                n: asdict(b) for n, b in self.lists.get(list_name, {}).items()
            }
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def import_list(self, list_name: str, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        for n, b in data.get("bookmarks", {}).items():
            self.add(list_name, n, Bookmark(**b))
