"""FM IF noise reduction (PyTorch counterpart of ``sdrtpu/kernels/fmnr.py``).

For every sample the original takes a windowed N-point FFT of the sliding
window, keeps the strongest bin and inverse-transforms its centre
element:

    out[i] = (-1)^{k_i} / N * X_{k_i}(i),
    X_k(i) = sum_m x[i+m] * w[m] * e^{-j 2 pi k m / N}

The sliding STFT is a bank of N FIR filters with modulated-window taps,
so the block computes as one `correlate_valid_bank` call, an argmax over
the bank and a gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .fir import correlate_valid_bank
from .windows import periodic_window


class FmIfNoiseReduction(StreamOp):
    """Keep-strongest-bin spectral noise reduction; leading axes of a
    (..., n) block are independent channels."""

    def __init__(self, bins: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.bins = n = int(bins)
        w = periodic_window("nuttall", n).astype(np.float64)
        m = np.arange(n)
        k = np.arange(n)[:, None]
        self.taps = (w[None, :] * np.exp(-2j * np.pi * k * m[None, :] / n)
                     ).astype(np.complex64)  # (N, N): the filter bank
        self.scale = ((-1.0) ** np.arange(n) / n).astype(np.float32)
        self._taps_t = torch.as_tensor(self.taps, device=self.device)
        self._scale_t = torch.as_tensor(self.scale, device=self.device)

    def init_state(self):
        return torch.zeros((self.bins - 1,), dtype=torch.complex64,
                           device=self.device)

    def _one(self, ext):
        ys = correlate_valid_bank(ext, self._taps_t)  # (N, n)
        best = torch.argmax(ys.abs(), dim=0)  # (n,)
        sel = torch.gather(ys, 0, best[None])[0]
        return sel * self._scale_t[best]

    def __call__(self, state, x):
        n = x.shape[-1]
        lead = x.shape[:-1]
        ext = torch.cat([state.expand(lead + (self.bins - 1,)),
                         x.to(torch.complex64)], dim=-1)
        rows = ext.reshape(-1, ext.shape[-1])
        out = torch.stack([self._one(row) for row in rows])
        return ext[..., n:], out.reshape(x.shape)
