"""FM de-emphasis (PyTorch counterpart of ``sdrtpu/kernels/iir.py``).

The one-pole lowpass ``y[n] = alpha*x[n] + (1-alpha)*y[n-1]`` has an
impulse response that underflows float32 within a few dozen samples at
audio rates, so it runs as a truncated-impulse FIR plus the
``a^(n+1) * y0`` carry term — fully parallel.  Poles with a longer memory
need the associative-scan form (`first_order_recurrence` in the
reference), which is not ported yet (ROADMAP.md M4).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .fir import correlate_valid, matmul_correlate_valid, toeplitz_matrix


class Deemphasis(StreamOp):
    """FM de-emphasis, ``alpha = dt / (tau + dt)``, on real (..., n) blocks.

    Branch choice as in the reference: the banded-Toeplitz matmul from
    ``mm_min_elements`` total elements, the shift-and-add below it (the
    two differ at rounding level, so the port must pick the same one).
    """

    _FIR_EPS = 1e-9
    _FIR_MAX_TAPS = 256

    def __init__(self, tau: float, samplerate: float, channels: int = 1,
                 mm_min_elements: int = 1 << 15, device="cuda"):
        self.device = resolve_device(device)
        dt = 1.0 / float(samplerate)
        self.alpha = np.float32(dt / (float(tau) + dt))
        self.channels = channels
        self.mm_min_elements = int(mm_min_elements)
        a = 1.0 - float(self.alpha)
        T = int(np.ceil(np.log(self._FIR_EPS) / np.log(a))) if a > 0 else 1
        if T > self._FIR_MAX_TAPS:
            raise NotImplementedError(
                "de-emphasis poles longer than 256 taps need the "
                "associative-scan recurrence (ROADMAP.md M4)")
        k = np.arange(T, dtype=np.float64)
        # correlate_valid orientation: h[t] = alpha * a^(T-1-t)
        self._fir = (float(self.alpha) * a ** (T - 1 - k)).astype(np.float32)
        self._ntaps = T
        self._H = torch.as_tensor(toeplitz_matrix(self._fir, 128),
                                  device=self.device)
        self._a = 1.0 - np.float64(self.alpha)

    def init_state(self):
        shape = () if self.channels == 1 else (self.channels, 1)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        T = self._ntaps
        n = x.shape[-1]
        xpad = torch.cat([x.new_zeros(x.shape[:-1] + (T - 1,)), x], dim=-1)
        if x.numel() >= self.mm_min_elements:
            y = matmul_correlate_valid(xpad, self._fir, H=self._H)
        else:
            y = correlate_valid(xpad, self._fir)
        # carry term a^(n+1)*y0: nonzero only in the first T outputs
        decay = np.zeros(n, np.float32)
        m = min(T, n)
        decay[:m] = (self._a ** (np.arange(m, dtype=np.float64) + 1.0)
                     ).astype(np.float32)
        y = y + torch.as_tensor(decay, device=x.device) * state
        return y[..., -1:], y
