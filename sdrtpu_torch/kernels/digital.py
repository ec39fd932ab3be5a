"""Bit-level digital primitives (PyTorch counterpart of
``sdrtpu/kernels/digital.py``).

All block-parallel: slicing and differential decoding are elementwise
or one-sample-shift operations.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..graph.block import StreamOp


def binary_slice(x: torch.Tensor) -> torch.Tensor:
    """float -> bit: 1 where x > 0."""
    return (x > 0.0).to(torch.uint8)


class DifferentialDecoder(StreamOp):
    """Mod-N differential decode: ``out[i] = (in[i] - in[i-1]) mod N``,
    carrying the last symbol."""

    def __init__(self, modulus: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.modulus = int(modulus)

    def init_state(self):
        return torch.zeros((), dtype=torch.uint8, device=self.device)

    def __call__(self, state, x):
        prev = torch.cat([state.to(x.dtype).reshape(1), x[:-1]])
        out = torch.remainder(
            x.to(torch.int32) - prev.to(torch.int32) + self.modulus,
            self.modulus).to(torch.uint8)
        return x[-1], out


class ManchesterDecoder(StreamOp):
    """Take every other symbol; block lengths must be even so the phase
    stays pinned."""

    def init_state(self):
        return ()

    def out_len(self, n: int) -> int:
        assert n % 2 == 0
        return n // 2

    def __call__(self, state, x):
        return state, x[..., ::2]
