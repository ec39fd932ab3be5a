"""Transmit-side modulators (PyTorch counterpart of ``sdrtpu/kernels/mod.py``).

- `QuadratureMod`: FM modulator, ``phase += dev*x; out = e^{j phase}``.
- `RrcInterpolator`: symbols upsampled by an integer factor with
  root-raised-cosine shaping (a `PolyphaseResampler` with an RRC
  prototype).
- `PskMod`: complex symbols -> RRC-shaped baseband.
- `GfskMod`: +/-1 bit pulses -> RRC-shaped frequency pulse -> FM.

The decoder tests take their signals from here, and the RyFi transmitter
shapes its symbols with `RrcInterpolator`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from . import taps as tapsmod
from .resample import PolyphaseResampler

_TWO_PI = np.float32(2 * np.pi)


def _mod(a, b):
    """float32 ``a mod b`` as numpy and jnp take it: an exact fmod, moved
    into b's sign."""
    r = np.fmod(a, b)
    return np.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


class QuadratureMod(StreamOp):
    """FM modulator: real input -> constant-envelope complex baseband.

    The phase is accumulated as the reference does, so it rounds the
    same way: a float32 cumsum within chunks of 64 samples (within a
    chunk the phase stays below ~64 pi rad, where float32 keeps ~1e-5
    rad), and the chunks' offsets a float32 running sum wrapped into
    [0, 2 pi) after every chunk.  That running sum is a serial chain of
    one add and one wrap per 64 samples; it runs on the host, over the
    chunk totals only.  State: the phase, wrapped into [-pi, pi).
    """

    _CHUNK = 64

    def __init__(self, deviation_hz: float, samplerate: float, device="cuda"):
        self.device = resolve_device(device)
        self.dev = float(np.float32(tapsmod.hz_to_rads(deviation_hz,
                                                       samplerate)))

    def init_state(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def __call__(self, state, x):
        n = x.shape[-1]
        d = self.dev * x.to(torch.float32)
        K = self._CHUNK
        if n % K:
            d = torch.cat([d, d.new_zeros(d.shape[:-1] + (K - n % K,))], -1)
        nc = d.shape[-1] // K
        within = torch.cumsum(d.reshape(d.shape[:-1] + (nc, K)), dim=-1)
        totals = within[..., -1].cpu().numpy()  # (..., nc)
        c = np.broadcast_to(np.asarray(state.cpu().numpy(), np.float32),
                            totals.shape[:-1]).copy()
        offs = np.empty_like(totals)
        for k in range(nc):
            offs[..., k] = c
            c = _mod(c + totals[..., k], _TWO_PI).astype(np.float32)
        phase = (torch.as_tensor(offs, device=x.device)[..., None]
                 + within).reshape(d.shape)[..., :n]
        new_state = (_mod(c + np.float32(np.pi), _TWO_PI).astype(np.float32)
                     - np.float32(np.pi))
        return (torch.as_tensor(new_state, device=x.device),
                torch.complex(torch.cos(phase), torch.sin(phase)))


class RrcInterpolator(StreamOp):
    """Interpolate symbols by an integer factor with RRC shaping.

    ``normalize_dc``: unit DC gain (the RyFi transmitter's convention);
    otherwise the prototype is scaled by ``sps``, unity symbol gain
    through the zero-stuffing interpolation."""

    def __init__(self, sps: int, rrc_tap_count: int = 33,
                 rrc_beta: float = 0.35, dtype=torch.complex64,
                 normalize_dc: bool = False, device="cuda"):
        self.sps = int(sps)
        proto = tapsmod.root_raised_cosine(rrc_tap_count, rrc_beta, float(sps))
        scale = 1.0 / float(proto.sum()) if normalize_dc else float(self.sps)
        self.poly = PolyphaseResampler(self.sps, 1, proto * np.float32(scale),
                                       dtype=dtype, device=device)

    def init_state(self):
        return self.poly.init_state()

    def out_len(self, n: int) -> int:
        return n * self.sps

    def __call__(self, state, syms):
        return self.poly(state, syms)


class PskMod(StreamOp):
    """Complex symbols -> RRC-shaped baseband at ``sps`` samples a symbol."""

    def __init__(self, sps: int, rrc_tap_count: int = 33,
                 rrc_beta: float = 0.35, device="cuda"):
        self.interp = RrcInterpolator(sps, rrc_tap_count, rrc_beta,
                                      torch.complex64, device=device)

    def init_state(self):
        return self.interp.init_state()

    def out_len(self, n):
        return self.interp.out_len(n)

    def __call__(self, state, syms):
        return self.interp(state, syms.to(torch.complex64))


class GfskMod(StreamOp):
    """+/-1 bit pulses -> RRC-shaped frequency pulse -> FM baseband."""

    def __init__(self, sps: int, deviation_hz: float, samplerate: float,
                 rrc_tap_count: int = 33, rrc_beta: float = 0.35,
                 device="cuda"):
        self.interp = RrcInterpolator(sps, rrc_tap_count, rrc_beta,
                                      torch.float32, device=device)
        self.mod = QuadratureMod(deviation_hz, samplerate, device=device)

    def init_state(self):
        return {"interp": self.interp.init_state(),
                "mod": self.mod.init_state()}

    def out_len(self, n):
        return self.interp.out_len(n)

    def __call__(self, state, bits):
        st = dict(state)
        st["interp"], pulse = self.interp(state["interp"],
                                          bits.to(torch.float32))
        st["mod"], y = self.mod(state["mod"], pulse)
        return st, y
