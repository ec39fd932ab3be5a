"""WFM broadcast demodulator (PyTorch counterpart of ``sdrtpu/kernels/wfm.py``).

    m    = quadrature_discriminate(iq)                  # MPX
    r    = real pilot bandpass(m)                       # 18.75-19.25 kHz
    c2   = r^2 / segment_mean(r^2) - 1                  # = Re(conj(vco)^2)
    lmr  = 2 * comp * delay(m) * c2                     # 38 kHz DSB decode
    L, R = delay(m) + lmr, delay(m) - lmr  (optional 15 kHz lowpass)

Ported: the ``"envelope"`` pilot mode (the flagship's), mono, the
subcarrier droop scalar, the ``mpx_eq`` FIR and the discriminator's
``channel_derotate``.  The ``"normalized"``, ``"regression"`` and
``"pll"`` pilot modes and the RDS tap need the loop and mixer modules,
which are not ported yet (ROADMAP.md M5/M9); they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from . import taps as tapsmod
from .demod import Quadrature
from .fir import Fir
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
    at the IF rate.  Returns ``(state, (audio, rds))`` with ``rds`` None."""

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
        if stereo and pilot_mode != "envelope":
            raise NotImplementedError(
                f"pilot_mode={pilot_mode!r} needs kernels/loops.py, which is "
                "not ported yet (ROADMAP.md M5); use pilot_mode='envelope'")
        if rds_out:
            raise NotImplementedError(
                "the RDS tap needs kernels/mixer.py FreqXlator, which is not "
                "ported yet (ROADMAP.md M5)")
        self.pilot_mode = pilot_mode
        self.rds_out = False
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
        # real bandpass = 2*Re(analytic bandpass), as banded-Toeplitz
        # float32 matmuls (the reference's "mm" choice)
        self.pilot_fir = Fir(2.0 * np.real(pilot_taps), dtype=torch.float32,
                             method="mm", device=dev)
        d = (len(pilot_taps) - 1) // 2 + 1
        self.lpr_delay = Delay(d, torch.float32, device=dev)
        audio_taps = tapsmod.low_pass(15000.0, 4000.0, samplerate)
        self.al_fir = Fir(audio_taps, dtype=torch.float32, device=dev)
        self.ar_fir = Fir(audio_taps, dtype=torch.float32, device=dev)

    def init_state(self):
        # same keys as the reference, so states convert one to one
        return {
            "quad": self.quad.init_state(),
            "eq": self.eq_fir.init_state() if self.eq_fir else (),
            "pilot_fir": self.pilot_fir.init_state(),
            "pll": (),
            "lpr_delay": self.lpr_delay.init_state(),
            "al": self.al_fir.init_state(),
            "ar": self.ar_fir.init_state(),
            "rds_xl": (),
            "rds_rs": (),
        }

    def out_len(self, n: int) -> int:
        return n

    def __call__(self, state, x):
        st = dict(state)
        st["quad"], m = self.quad(state["quad"], x)
        if self.eq_fir is not None:
            st["eq"], m = self.eq_fir(state["eq"], m)

        if not self.stereo:
            if self.low_pass:
                st["al"], m = self.al_fir(state["al"], m)
            return st, (torch.stack([m, m]), None)

        st["pilot_fir"], r = self.pilot_fir(state["pilot_fir"], m)
        r2 = r * r
        seg = max(1, round(0.01 * self.samplerate))  # ~10 ms
        c2 = r2 / torch.clamp(_segment_mean(r2, seg), min=1e-12) - 1.0

        st["lpr_delay"], lpr = self.lpr_delay(state["lpr_delay"], m)
        lmr = float(2.0 * self.subcarrier_comp) * lpr * c2
        left = lpr + lmr
        right = lpr - lmr
        if self.low_pass:
            st["al"], left = self.al_fir(state["al"], left)
            st["ar"], right = self.ar_fir(state["ar"], right)
        return st, (torch.stack([left, right]), None)
