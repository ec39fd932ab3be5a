"""Soft-symbol (.s) file IO (host copy of ``sdrtpu/io/symbols.py``).

The reference writes interleaved int8 soft symbols scaled by 84 and
clamped to [-127, 127] (``meteor_demodulator/src/main.cpp:193-224``).
"""

from __future__ import annotations

import numpy as np

SOFT_SCALE = 84.0


def _host(a) -> np.ndarray:
    """A numpy view of ``a``; a torch tensor is copied to the host."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def quantize_soft(symbols: np.ndarray) -> np.ndarray:
    """complex symbols -> interleaved int8 (re, im) pairs, x84 clamp 127."""
    out = np.empty(symbols.size * 2, np.int8)
    out[0::2] = np.clip(np.round(symbols.real * SOFT_SCALE), -127, 127)
    out[1::2] = np.clip(np.round(symbols.imag * SOFT_SCALE), -127, 127)
    return out


def dequantize_soft(data: np.ndarray) -> np.ndarray:
    d = np.asarray(data, np.int8).astype(np.float32) / SOFT_SCALE
    return (d[0::2] + 1j * d[1::2]).astype(np.complex64)


class SoftSymbolWriter:
    """Streaming .s writer accepting masked symbol blocks."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, symbols, valid=None):
        """Append ``symbols`` (numpy or a torch tensor on any device; only
        the ``valid`` ones when a mask is given)."""
        symbols = _host(symbols)
        if valid is not None:
            symbols = symbols[_host(valid).astype(bool)]
        self._f.write(quantize_soft(symbols).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_soft_file(path: str) -> np.ndarray:
    return dequantize_soft(np.fromfile(path, np.int8))
