"""Small stream utilities (PyTorch counterpart of ``sdrtpu/kernels/util.py``)."""

from __future__ import annotations

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
