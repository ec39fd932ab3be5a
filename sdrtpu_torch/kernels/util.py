"""Small stream utilities (PyTorch counterpart of ``sdrtpu/kernels/util.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp


class Delay(StreamOp):
    """Pure sample delay of D samples; state: the last D input samples
    (zeros initially)."""

    def __init__(self, delay: int, dtype=torch.complex64, device="cuda"):
        self.device = resolve_device(device)
        self.delay = int(delay)
        self.dtype = dtype

    def init_state(self):
        return torch.zeros((self.delay,), dtype=self.dtype,
                           device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        x = x.to(self.dtype)
        state = state.expand(x.shape[:-1] + (self.delay,))
        ext = torch.cat([state, x], dim=-1)
        return ext[..., n:], ext[..., :n]


class Volume(StreamOp):
    """Gain and mute on audio (``audio/volume.h``); stateless."""

    def __init__(self, level: float = 1.0, muted: bool = False):
        self.gain = float(np.float32(0.0 if muted else level))

    def init_state(self):
        return ()

    def __call__(self, state, x):
        return state, x * self.gain


def lr_to_stereo(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Stack L and R into (2, n) stereo (``convert/l_r_to_stereo.h``)."""
    return torch.stack([l, r])


def mono_to_stereo(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x, x])


def stereo_to_mono(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x[0] + x[1])
