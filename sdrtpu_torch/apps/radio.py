"""Radio chain: one VFO's demodulation stack (PyTorch counterpart of
``sdrtpu/apps/radio.py``).

    VFO IQ @ IF rate
      -> IF chain: [NoiseBlanker] [PowerSquelch] [FmIfNoiseReduction]
      -> demodulator (per mode)
      -> AF chain: [CTCSS] resampler(IF -> audio) [HPF 300 Hz] [de-emphasis]
      -> audio @ audio_rate

| mode | IF rate | default bw | de-emphasis |
|------|---------|-----------|-------------|
| wfm  | 250 kHz | 150 kHz   | 50 us       |
| nfm  | 50 kHz  | 12.5 kHz  | off         |
| am   | 15 kHz  | 10 kHz    | off         |
| usb  | 24 kHz  | 2.8 kHz   | off         |
| lsb  | 24 kHz  | 2.8 kHz   | off         |
| dsb  | 24 kHz  | 4.6 kHz   | off         |
| cw   | 3 kHz   | 200 Hz    | off         |
| raw  | audio   | audio     | off         |

Each call is the span ``sdrtpu.rx.radio`` (`metrics.span`), its mode
the argument.  Inside it the chain's body (`RadioChain._step`) runs
through the chain's own `graph.cuda_graph.GraphedStep`: eagerly on the
CPU and on an input key's first pass on the card, then as one captured
CUDA graph per key, replayed; its counters are ``_graph.captures``,
``.replays`` and ``.eager_passes``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp, tree_map
from ..graph.cuda_graph import GraphedStep
from ..kernels import taps as tapsmod
from ..kernels.analog import Am, Cw, Fm, Ssb
from ..kernels.ctcss import CtcssSquelch
from ..kernels.fir import Fir
from ..kernels.fmnr import FmIfNoiseReduction
from ..kernels.iir import Deemphasis
from ..kernels.resample import RationalResampler
from ..kernels.squelch import NoiseBlanker, PowerSquelch
from ..kernels.wfm import BroadcastFm
from ..metrics import span

MODE_INFO = {
    "wfm": dict(if_rate=250000.0, bandwidth=150000.0, deemp=50e-6),
    "nfm": dict(if_rate=50000.0, bandwidth=12500.0, deemp=None),
    "am": dict(if_rate=15000.0, bandwidth=10000.0, deemp=None),
    "usb": dict(if_rate=24000.0, bandwidth=2800.0, deemp=None),
    "lsb": dict(if_rate=24000.0, bandwidth=2800.0, deemp=None),
    "dsb": dict(if_rate=24000.0, bandwidth=4600.0, deemp=None),
    "cw": dict(if_rate=3000.0, bandwidth=200.0, deemp=None),
    # RAW: IQ passthrough at the audio rate (I -> L, Q -> R)
    "raw": dict(if_rate=48000.0, bandwidth=48000.0, deemp=None),
}


class RadioChain(StreamOp):
    """One VFO's radio: IF conditioning, demodulator, AF processing.

    Input: complex IQ at ``MODE_INFO[mode]['if_rate']``.
    Output: (2, n_audio) stereo float32 at ``audio_rate``.
    """

    def __init__(self, mode: str, audio_rate: float = 48000.0,
                 bandwidth: float | None = None,
                 squelch_db: float | None = None,
                 noise_blanker: bool = False, high_pass: bool = False,
                 fm_if_nr: bool = False,
                 deemphasis: float | None = "default", stereo: bool = True,
                 rds: bool = False, ctcss_tone: int | None = None,
                 pilot_mode: str = "normalized", device="cuda"):
        if mode not in MODE_INFO:
            raise ValueError(f"unknown mode {mode}")
        self.device = resolve_device(device)
        dev = self.device
        info = dict(MODE_INFO[mode])
        if mode == "raw":
            info["if_rate"] = float(audio_rate)
        self.mode = mode
        self.if_rate = info["if_rate"]
        self.audio_rate = float(audio_rate)
        bw = bandwidth if bandwidth is not None else info["bandwidth"]
        self.bandwidth = bw

        self.nb = NoiseBlanker(device=dev) if noise_blanker else None
        self.squelch = (PowerSquelch(squelch_db, device=dev)
                        if squelch_db is not None else None)
        self.fmnr = FmIfNoiseReduction(32, device=dev) if fm_if_nr else None
        # the CTCSS gate sits on the demodulated audio ahead of the AF
        # resampler
        self.ctcss = (CtcssSquelch(self.if_rate, required_tone=ctcss_tone,
                                   device=dev)
                      if ctcss_tone is not None else None)

        if mode == "wfm":
            # mpx_eq on: the radio's IF always comes from a decimating
            # front end, so the discriminator's sinc droop is always there
            self.demod = BroadcastFm(
                deviation=bw / 2.0, samplerate=self.if_rate, stereo=stereo,
                rds_out=rds, pilot_mode=pilot_mode, mpx_eq=True, device=dev)
        elif mode == "nfm":
            self.demod = Fm(self.if_rate, bw, device=dev)
        elif mode == "am":
            self.demod = Am(self.if_rate, bw, device=dev)
        elif mode in ("usb", "lsb", "dsb"):
            self.demod = Ssb(self.if_rate, bw, mode=mode, device=dev)
        elif mode == "cw":
            self.demod = Cw(self.if_rate, device=dev)
        else:
            self.demod = None  # raw

        self.resamp = RationalResampler(self.if_rate, audio_rate, device=dev)
        self.hpf = (Fir(tapsmod.high_pass(300.0, 100.0, audio_rate),
                        dtype=torch.float32, device=dev)
                    if high_pass else None)
        if deemphasis == "default":
            deemphasis = info["deemp"]
        self.deemph = (Deemphasis(deemphasis, audio_rate, channels=2,
                                  device=dev)
                       if deemphasis else None)
        self._graph = GraphedStep()

    @staticmethod
    def ctcss_tone_detected(state) -> int | None:
        """Host-side read of the decoded CTCSS tone index from a chain
        state (None when no CTCSS gate is configured)."""
        st = state.get("ctcss") if isinstance(state, dict) else None
        if not st:
            return None
        return int(st["tone"])

    def block_multiple(self) -> int:
        m = self.resamp.block_multiple()
        if self.ctcss is not None:
            m = int(np.lcm(m, self.ctcss.block_multiple()))
        return m

    def init_state(self):
        """The chain's state, its AF stages' carries in the stereo shape
        that a pass leaves them in, so that every pass has one input key
        (one graph on the card)."""
        def stereo(tree):
            return tree_map(lambda t: t.expand(2, *t.shape).clone(), tree)

        return {
            "nb": self.nb.init_state() if self.nb else (),
            "sq": self.squelch.init_state() if self.squelch else (),
            "fmnr": self.fmnr.init_state() if self.fmnr else (),
            "ctcss": self.ctcss.init_state() if self.ctcss else (),
            "demod": self.demod.init_state() if self.demod else (),
            "resamp": stereo(self.resamp.init_state()),
            "hpf": stereo(self.hpf.init_state()) if self.hpf else (),
            "deemph": self.deemph.init_state() if self.deemph else (),
        }

    def out_len(self, n: int) -> int:
        return self.resamp.out_len(n)

    def __call__(self, state, x):
        with span("sdrtpu.rx.radio", self.mode):
            return self._graph(self._step, state, x)

    def _step(self, state, x):
        """The chain's body: IF chain, demodulator, CTCSS, audio
        resampler, HPF, de-emphasis."""
        st = dict(state)
        if self.nb:
            st["nb"], x = self.nb(state["nb"], x)
        if self.squelch:
            st["sq"], x = self.squelch(state["sq"], x)
        if self.fmnr:
            st["fmnr"], x = self.fmnr(state["fmnr"], x)

        if self.mode == "wfm":
            st["demod"], (audio, _rds) = self.demod(state["demod"], x)
        elif self.mode == "raw":
            audio = torch.stack([x.real, x.imag])
        else:
            st["demod"], mono = self.demod(state["demod"], x)
            audio = torch.stack([mono, mono])

        if self.ctcss:
            st["ctcss"], (audio, _tone) = self.ctcss(state["ctcss"], audio)
        st["resamp"], a = self.resamp(state["resamp"],
                                      audio.to(torch.complex64))
        a = a.real
        if self.hpf:
            st["hpf"], a = self.hpf(state["hpf"], a)
        if self.deemph:
            st["deemph"], a = self.deemph(state["deemph"], a)
        return st, a
