"""FM discriminator (PyTorch counterpart of ``sdrtpu/kernels/demod.py``).

    d[n] = angle(x[n] * conj(x[n-1])) / (2*pi*deviation/fs)

computed across the whole block with exact atan2; the only carry is the
last input sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .taps import hz_to_rads


class Quadrature(StreamOp):
    """FM discriminator: a tone at +deviation Hz demodulates to +1.0.

    State: the previous complex sample (1+0j initially).  With
    ``channel_derotate`` the state also holds a per-channel angle "rot"
    (seeded by the owner with the channelizer's residual rate): the
    residual carrier a DDC left in the IF adds that constant angle to
    every product sample, so one constant complex multiply removes it.
    """

    def __init__(self, deviation_hz: float, samplerate: float,
                 channel_derotate: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.inv_deviation = np.float32(
            1.0 / hz_to_rads(deviation_hz, samplerate))
        self.channel_derotate = bool(channel_derotate)

    def init_state(self):
        prev = torch.ones((), dtype=torch.complex64, device=self.device)
        if self.channel_derotate:
            return {"prev": prev,
                    "rot": torch.zeros((), dtype=torch.float32,
                                       device=self.device)}
        return prev

    def _discriminate(self, prev, x, rot=None):
        prevb = prev.expand(x.shape[:-1])
        ext = torch.cat([prevb[..., None], x], dim=-1)
        d = ext[..., 1:] * torch.conj(ext[..., :-1])
        if rot is not None:
            comp = torch.complex(torch.cos(rot), torch.sin(rot))
            d = d * comp[..., None]
        return torch.atan2(d.imag, d.real) * float(self.inv_deviation)

    def __call__(self, state, x):
        if self.channel_derotate:
            y = self._discriminate(state["prev"], x, state["rot"])
            return {"prev": x[..., -1], "rot": state["rot"]}, y
        return x[..., -1], self._discriminate(state, x)


def complex_to_real(x: torch.Tensor) -> torch.Tensor:
    """``convert::ComplexToReal``: the real part."""
    return x.real


def real_to_complex(x: torch.Tensor) -> torch.Tensor:
    """``convert::RealToComplex``: a zero imaginary part."""
    return x.to(torch.complex64)
