"""Constellation and symbol diagrams — GUI-widget parity as arrays
(PyTorch counterpart of ``sdrtpu/apps/diagrams.py``; host code).

The reference renders these with ImGui
(``core/src/gui/widgets/{constellation_diagram,symbol_diagram}.h``); here
they are ring buffers of recent symbols plus rasterizers producing
plot-ready arrays (and an optional density image for waterfall-style
constellation displays).  ``push`` takes numpy or a torch tensor on any
device; the rings are host numpy.
"""

from __future__ import annotations

import numpy as np

from ..convert import to_numpy


class ConstellationDiagram:
    """Ring of recent complex symbols (default 1024, like the widget)."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.complex64)
        self._n = 0

    def push(self, symbols: np.ndarray) -> None:
        s = to_numpy(symbols).astype(np.complex64).ravel()[-self.capacity :]
        k = len(s)
        if k == 0:  # buf[-0:] would select the WHOLE buffer
            return
        self._buf = np.roll(self._buf, -k)
        self._buf[-k:] = s
        self._n = min(self._n + k, self.capacity)

    @property
    def points(self) -> np.ndarray:
        return self._buf[-self._n :] if self._n else self._buf[:0]

    def density(self, size: int = 128, span: float = 1.5) -> np.ndarray:
        """2-D histogram image of the constellation (size x size uint8)."""
        p = self.points
        if not len(p):
            return np.zeros((size, size), np.uint8)
        ix = np.clip(((p.real + span) / (2 * span) * size).astype(int), 0, size - 1)
        iy = np.clip(((p.imag + span) / (2 * span) * size).astype(int), 0, size - 1)
        img = np.zeros((size, size), np.int64)
        np.add.at(img, (size - 1 - iy, ix), 1)
        m = img.max()
        return (img * (255 / m)).astype(np.uint8) if m else img.astype(np.uint8)

    def evm(self, reference_points: np.ndarray | None = None) -> float:
        """RMS error-vector magnitude vs nearest reference point (QPSK default)."""
        p = self.points
        if not len(p):
            return float("nan")
        if reference_points is None:
            reference_points = np.exp(
                1j * (np.arange(4) * np.pi / 2 + np.pi / 4)
            )
        d = np.abs(p[:, None] - reference_points[None, :]).min(axis=1)
        return float(np.sqrt(np.mean(d**2)))


class SymbolDiagram:
    """Ring of recent real-valued symbols (eye/level diagram source)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float32)
        self._n = 0

    def push(self, symbols: np.ndarray) -> None:
        s = to_numpy(symbols).astype(np.float32).ravel()[-self.capacity :]
        k = len(s)
        if k == 0:  # buf[-0:] would select the WHOLE buffer
            return
        self._buf = np.roll(self._buf, -k)
        self._buf[-k:] = s
        self._n = min(self._n + k, self.capacity)

    @property
    def values(self) -> np.ndarray:
        return self._buf[-self._n :] if self._n else self._buf[:0]

    def histogram(self, bins: int = 64, lo: float = -1.5, hi: float = 1.5):
        return np.histogram(self.values, bins=bins, range=(lo, hi))
