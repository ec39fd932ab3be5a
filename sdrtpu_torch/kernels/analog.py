"""NFM / AM / SSB / CW demodulators (PyTorch counterpart of
``sdrtpu/kernels/analog.py``).

- `Fm` (NFM): discriminator at deviation = bandwidth/2 plus an optional
  audio lowpass (cutoff bw/2, 10% transition).
- `Am`: optional carrier AGC (complex), magnitude, DC block, optional
  audio AGC, lowpass.  AGC defaults as the radio module: set point 1,
  attack 50/fs, decay 5/fs, max gain 1e7, max output 10, initial gain
  inf, so the average starts at 0.
- `Ssb`: translate by +-bw/2 (USB/LSB; DSB untranslated), real part, AGC.
- `Cw`: translate by the tone offset, real part, AGC.

All output mono float32 at the IF rate.  Every AGC is one `agc_scan`
launch per block on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from . import taps as tapsmod
from .demod import Quadrature
from .fir import Fir
from .iir import DcBlocker
from .loops import Agc
from .mixer import FreqXlator


def _audio_agc(samplerate: float, attack: float = 50.0, decay: float = 5.0,
               device="cuda") -> Agc:
    return Agc(set_point=1.0, attack=attack / samplerate,
               decay=decay / samplerate, max_gain=10e6, max_output_amp=10.0,
               init_gain=np.inf, device=device)


class Fm(StreamOp):
    """Narrowband FM demod: IF rate 50 kHz in the radio."""

    def __init__(self, samplerate: float, bandwidth: float,
                 low_pass: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.quad = Quadrature(bandwidth / 2.0, samplerate,
                               device=self.device)
        self.low_pass = low_pass
        if low_pass:
            self.lpf = Fir(
                tapsmod.low_pass(bandwidth / 2.0, bandwidth * 0.05,
                                 samplerate),
                dtype=torch.float32, device=self.device)

    def init_state(self):
        return {"quad": self.quad.init_state(),
                "lpf": self.lpf.init_state() if self.low_pass else ()}

    def __call__(self, state, x):
        st = dict(state)
        st["quad"], y = self.quad(state["quad"], x)
        if self.low_pass:
            st["lpf"], y = self.lpf(state["lpf"], y)
        return st, y


class Am(StreamOp):
    """AM envelope demod: IF rate 15 kHz in the radio."""

    def __init__(self, samplerate: float, bandwidth: float,
                 agc_mode: str = "audio", agc_attack: float = 50.0,
                 agc_decay: float = 5.0, dc_block_rate: float | None = None,
                 device="cuda"):
        assert agc_mode in ("carrier", "audio")
        self.device = resolve_device(device)
        dev = self.device
        self.agc_mode = agc_mode
        self.carrier_agc = _audio_agc(samplerate, agc_attack, agc_decay, dev)
        self.audio_agc = _audio_agc(samplerate, agc_attack, agc_decay, dev)
        rate = (dc_block_rate if dc_block_rate is not None
                else 100.0 / samplerate)
        self.dc_block = DcBlocker(rate, dtype=torch.float32, device=dev)
        self.lpf = Fir(
            tapsmod.low_pass(bandwidth / 2.0, bandwidth * 0.05, samplerate),
            dtype=torch.float32, device=dev)

    def init_state(self):
        return {"cagc": self.carrier_agc.init_state(),
                "aagc": self.audio_agc.init_state(),
                "dc": self.dc_block.init_state(),
                "lpf": self.lpf.init_state()}

    def __call__(self, state, x):
        st = dict(state)
        if self.agc_mode == "carrier":
            st["cagc"], x = self.carrier_agc(state["cagc"], x)
        y = x.abs().to(torch.float32)
        st["dc"], y = self.dc_block(state["dc"], y)
        if self.agc_mode == "audio":
            st["aagc"], y = self.audio_agc(state["aagc"], y)
        st["lpf"], y = self.lpf(state["lpf"], y)
        return st, y


class _XlateRealAgc(StreamOp):
    """Translate, take the real part, AGC: the shape of SSB and CW."""

    def __init__(self, translation: float, samplerate: float,
                 agc_attack: float, agc_decay: float, device):
        self.device = resolve_device(device)
        self.xlator = FreqXlator(translation, samplerate, device=self.device)
        self.agc = _audio_agc(samplerate, agc_attack, agc_decay, self.device)

    def init_state(self):
        return {"xl": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        st = dict(state)
        st["xl"], y = self.xlator(state["xl"], x)
        st["agc"], y = self.agc(state["agc"], y.real)
        return st, y


class Ssb(_XlateRealAgc):
    """SSB/DSB demod: IF rate 24 kHz in the radio."""

    def __init__(self, samplerate: float, bandwidth: float,
                 mode: str = "usb", agc_attack: float = 50.0,
                 agc_decay: float = 5.0, device="cuda"):
        assert mode in ("usb", "lsb", "dsb")
        translation = {"usb": bandwidth / 2.0, "lsb": -bandwidth / 2.0,
                       "dsb": 0.0}[mode]
        super().__init__(translation, samplerate, agc_attack, agc_decay,
                         device)


class Cw(_XlateRealAgc):
    """CW demod with an audible tone offset: IF rate 3 kHz."""

    def __init__(self, samplerate: float, tone: float = 800.0,
                 agc_attack: float = 50.0, agc_decay: float = 5.0,
                 device="cuda"):
        super().__init__(tone, samplerate, agc_attack, agc_decay, device)
