"""Squelch and noise blanking (PyTorch counterpart of
``sdrtpu/kernels/squelch.py``).

- `PowerSquelch`: zeroes the whole block when the mean amplitude in dB is
  below the threshold (block-granular, as the reference).
- `NoiseBlanker`: one-pole average of |x| (a linear recurrence with
  per-sample coefficients) and a gain of 1/excess for samples whose
  amplitude exceeds ``level`` times the average.

The CTCSS squelch and the FM IF noise reduction are in `ctcss.py` and
`fmnr.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .iir import first_order_recurrence


class PowerSquelch(StreamOp):
    """Zero the block when 10*log10(mean |x|) < level (dB)."""

    def __init__(self, level_db: float = -50.0, device="cuda"):
        self.device = resolve_device(device)
        self.level_db = np.float32(level_db)

    def init_state(self):
        return ()

    def __call__(self, state, x):
        mean_amp = torch.mean(x.abs(), dim=-1, keepdim=True)
        open_ = (10.0 * torch.log10(torch.clamp(mean_amp, min=1e-20))
                 >= float(self.level_db))
        return state, torch.where(open_, x, torch.zeros_like(x))


class NoiseBlanker(StreamOp):
    """Impulse blanker.  Radio defaults: rate = 500/24000, level = 10.
    State: the running average amplitude."""

    def __init__(self, rate: float = 500.0 / 24000.0, level: float = 10.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.rate = np.float32(rate)
        self.level = np.float32(level)

    def init_state(self):
        return torch.ones((), dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        amps = x.abs().to(torch.float32)
        # a zero-amplitude sample holds the average (a = 1, b = 0): a
        # silent stretch behind a closed squelch must not decay it to 0,
        # or the first samples after it would be crushed by 1/excess
        live = amps != 0.0
        keep = float(np.float32(1.0) - self.rate)
        a = torch.where(live, keep, 1.0).to(torch.float32)
        b = torch.where(live, float(self.rate) * amps,
                        torch.zeros_like(amps))
        avg = first_order_recurrence(a, b, state)
        # the average is updated before the sample's excess is taken
        excess = amps / torch.clamp(avg, min=1e-20)
        gain = torch.where(excess > float(self.level), 1.0 / excess,
                           torch.ones_like(excess))
        gain = torch.where(live, gain, torch.ones_like(gain))
        new_state = avg[..., -1] if avg.ndim == 1 else avg[..., -1:]
        return new_state, x * gain
