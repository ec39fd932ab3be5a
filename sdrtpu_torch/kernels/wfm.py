"""WFM broadcast demodulator (PyTorch counterpart of ``sdrtpu/kernels/wfm.py``).

    m    = quadrature_discriminate(iq)                  # MPX
    c2   = Re(conj(vco)^2) from the 19 kHz pilot (see below)
    lmr  = 2 * comp * delay(m) * c2                     # 38 kHz DSB decode
    L, R = delay(m) + lmr, delay(m) - lmr  (optional 15 kHz lowpass)
    rds  = resample(xlate(m, -57 kHz), 5 kHz)           # optional tap

Pilot tracking modes:

- ``"envelope"`` (the flagship's): a REAL pilot bandpass r = A*sin(theta)
  gives ``c2 = r^2 / segment_mean(r^2) - 1`` exactly, with no complex
  filtering;
- ``"normalized"``: vco = p/|p| of the complex-filtered pilot;
- ``"regression"``: per-block linear phase fit (`loops.pilot_phase_fit`);
- ``"pll"``: the sequential PLL (19 kHz +/-250 Hz, bandwidth 25000/fs),
  one `loops.pll_scan` launch per block on the card.

Both the L+R and the L-R path are delayed by ``(pilot_taps-1)/2 + 1``
samples; the +1 compensates the PLL and is kept in every mode so the
modes' outputs line up.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from . import taps as tapsmod
from .demod import Quadrature
from .fir import Fir
from .loops import NormalizedPilot, Pll, pilot_phase_fit
from .mixer import FreqXlator
from .resample import RationalResampler
from .util import Delay


def _segment_mean(r2: torch.Tensor, seg: int) -> torch.Tensor:
    """Per-segment mean along the last axis, broadcast back to shape;
    rows not divisible by ``seg`` use a whole-row mean."""
    n = r2.shape[-1]
    if n % seg:
        return torch.mean(r2, dim=-1, keepdim=True)
    shp = r2.shape[:-1] + (n // seg, seg)
    m = torch.mean(r2.reshape(shp), dim=-1, keepdim=True)
    return m.expand(shp).reshape(r2.shape)


class BroadcastFm(StreamOp):
    """WFM demod: complex IQ at ``samplerate`` -> (2, ..., n) stereo audio
    at the IF rate.  Returns ``(state, (audio, rds))``; ``rds`` is the
    57 kHz subcarrier at 5 kHz complex when ``rds_out``, else None."""

    def __init__(self, deviation: float = 75000.0,
                 samplerate: float = 250000.0, stereo: bool = True,
                 low_pass: bool = True, rds_out: bool = False,
                 pilot_mode: str = "normalized", mpx_eq: bool = False,
                 subcarrier_droop_comp: bool = False,
                 channel_derotate: bool = False, device="cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.samplerate = float(samplerate)
        self.stereo = stereo
        self.low_pass = low_pass
        assert pilot_mode in ("envelope", "normalized", "regression", "pll")
        self.pilot_mode = pilot_mode
        self.rds_out = bool(rds_out)
        self.mpx_eq = bool(mpx_eq)
        self.eq_fir = (Fir(tapsmod.inverse_sinc(11, samplerate),
                           dtype=torch.float32, device=dev)
                       if self.mpx_eq else None)
        self.subcarrier_comp = np.float32(1.0)
        if subcarrier_droop_comp and stereo:
            f = np.linspace(0.0, 15000.0, 301)
            gain = 0.5 * (np.sinc((38000.0 - f) / self.samplerate)
                          + np.sinc((38000.0 + f) / self.samplerate))
            self.subcarrier_comp = np.float32(2.0 / (gain.max() + gain.min()))

        self.quad = Quadrature(deviation, samplerate,
                               channel_derotate=channel_derotate, device=dev)
        pilot_taps = tapsmod.band_pass(
            18750.0, 19250.0, 3000.0, samplerate, odd_tap_count=True)
        if pilot_mode == "envelope":
            # real bandpass = 2*Re(analytic bandpass), as banded-Toeplitz
            # float32 matmuls (the reference's "mm" choice)
            self.pilot_fir = Fir(2.0 * np.real(pilot_taps),
                                 dtype=torch.float32, method="mm", device=dev)
        else:
            self.pilot_fir = Fir(pilot_taps, dtype=torch.complex64, device=dev)
        d = (len(pilot_taps) - 1) // 2 + 1
        self.lpr_delay = Delay(d, torch.float32, device=dev)
        if pilot_mode == "pll":
            self.pilot_pll = Pll(
                25000.0 / samplerate, init_phase=0.0,
                init_freq=tapsmod.hz_to_rads(19000.0, samplerate),
                min_freq=tapsmod.hz_to_rads(18750.0, samplerate),
                max_freq=tapsmod.hz_to_rads(19250.0, samplerate), device=dev)
        elif pilot_mode == "envelope":
            self.pilot_pll = None
        else:
            self.pilot_pll = NormalizedPilot(device=dev)
        audio_taps = tapsmod.low_pass(15000.0, 4000.0, samplerate)
        self.al_fir = Fir(audio_taps, dtype=torch.float32, device=dev)
        self.ar_fir = Fir(audio_taps, dtype=torch.float32, device=dev)
        if self.rds_out:
            self.rds_xlator = FreqXlator(-57000.0, samplerate, device=dev)
            self.rds_resamp = RationalResampler(samplerate, 5000.0, device=dev)
        else:
            self.rds_xlator = None
            self.rds_resamp = None

    def init_state(self):
        # same keys as the reference, so states convert one to one
        return {
            "quad": self.quad.init_state(),
            "eq": self.eq_fir.init_state() if self.eq_fir else (),
            "pilot_fir": self.pilot_fir.init_state(),
            "pll": self.pilot_pll.init_state() if self.pilot_pll else (),
            "lpr_delay": self.lpr_delay.init_state(),
            "al": self.al_fir.init_state(),
            "ar": self.ar_fir.init_state(),
            "rds_xl": self.rds_xlator.init_state() if self.rds_xlator else (),
            "rds_rs": self.rds_resamp.init_state() if self.rds_resamp else (),
        }

    def out_len(self, n: int) -> int:
        return n

    def rds_len(self, n: int) -> int:
        return self.rds_resamp.out_len(n) if self.rds_resamp else 0

    def _rds_tap(self, st, state, m):
        st["rds_xl"], rc = self.rds_xlator(state["rds_xl"],
                                           m.to(torch.complex64))
        st["rds_rs"], rds = self.rds_resamp(state["rds_rs"], rc)
        return rds

    def __call__(self, state, x):
        st = dict(state)
        st["quad"], m = self.quad(state["quad"], x)
        if self.eq_fir is not None:
            st["eq"], m = self.eq_fir(state["eq"], m)

        rds = None
        if not self.stereo:
            if self.rds_out:
                rds = self._rds_tap(st, state, m)
            if self.low_pass:
                st["al"], m = self.al_fir(state["al"], m)
            return st, (torch.stack([m, m]), rds)

        if self.pilot_mode == "envelope":
            st["pilot_fir"], r = self.pilot_fir(state["pilot_fir"], m)
            r2 = r * r
            seg = max(1, round(0.01 * self.samplerate))  # ~10 ms
            c2 = r2 / torch.clamp(_segment_mean(r2, seg), min=1e-12) - 1.0
        else:
            st["pilot_fir"], p = self.pilot_fir(state["pilot_fir"],
                                                m.to(torch.complex64))
            if self.pilot_mode == "regression":
                vco = pilot_phase_fit(p, 19000.0, self.samplerate)
            else:
                st["pll"], vco = self.pilot_pll(state["pll"], p)
            c2 = (torch.conj(vco) * torch.conj(vco)).real

        st["lpr_delay"], lpr = self.lpr_delay(state["lpr_delay"], m)
        lmr = float(2.0 * self.subcarrier_comp) * lpr * c2
        if self.rds_out:
            rds = self._rds_tap(st, state, m)
        left = lpr + lmr
        right = lpr - lmr
        if self.low_pass:
            st["al"], left = self.al_fir(state["al"], left)
            st["ar"], right = self.ar_fir(state["ar"], right)
        return st, (torch.stack([left, right]), rds)
