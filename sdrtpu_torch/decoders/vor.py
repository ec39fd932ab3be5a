"""VOR navigation receiver (PyTorch counterpart of ``sdrtpu/decoders/vor.py``;
``decoder_modules/vor_receiver`` capability).

A VOR station transmits a 30 Hz AM "variable" tone whose phase (relative
to a 30 Hz reference frequency-modulated on a 9960 Hz subcarrier at
+/-480 Hz deviation) equals the magnetic bearing from the station.

Block-parallel, on the receiver's device:

    IQ @ fs (centered)  -> |.| AM envelope
      variable tone  = single-bin DFT of envelope at 30 Hz
      subcarrier     = bandpass 9960 +/- 600 Hz -> FM discriminator
      reference tone = single-bin DFT of discriminated subcarrier at 30 Hz
      bearing        = angle(var) - angle(ref)     (mod 360 deg)

Each DFT bin spans the whole block (many 30 Hz cycles): it demodulates
and averages at once.  State: the band-pass FIR's tail and the
discriminator's previous sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from ..kernels import taps as tapsmod
from ..kernels.demod import Quadrature
from ..kernels.fir import Fir

SUBCARRIER_HZ = 9960.0
TONE_HZ = 30.0
SUB_DEVIATION = 480.0


def _single_bin(x: torch.Tensor, freq: float, fs: float) -> torch.Tensor:
    """Complex amplitude of ``freq`` in real signal x (block-long DFT bin).

    The phase is formed in float32 as the reference forms it: the
    complex64 scalar ``-2j*pi*float32(freq/fs)`` times a float32 index."""
    n = x.shape[-1]
    w_step = np.float32((-2j * np.pi * np.float32(freq / fs)).imag)
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    ph = idx * float(w_step)
    w = torch.complex(torch.cos(ph), torch.sin(ph))
    return torch.sum(x * w, dim=-1) * (2.0 / n)


class VorReceiver(StreamOp):
    """IQ block -> (bearing_deg, signal_amplitude).

    ``samplerate`` should comfortably contain the 9960 Hz subcarrier
    (the reference uses 25 kHz); blocks should span >= ~10 tone cycles
    (>= 1/3 s) for a stable bearing.
    """

    def __init__(self, samplerate: float = 25000.0, device="cuda"):
        self.device = resolve_device(device)
        self.fs = float(samplerate)
        bpf_taps = tapsmod.band_pass(
            SUBCARRIER_HZ - 600.0, SUBCARRIER_HZ + 600.0, 400.0, samplerate,
            odd_tap_count=True)
        self.sub_bpf = Fir(bpf_taps, dtype=torch.complex64,
                           device=self.device)
        self.fm = Quadrature(SUB_DEVIATION, samplerate, device=self.device)
        # the reference path is delayed by the band-pass group delay (plus
        # half a sample from the discriminator); at 30 Hz that is a fixed
        # phase, subtracted from the measured difference
        self._trim = len(bpf_taps)  # drop filter/discriminator transients
        gd = (len(bpf_taps) - 1) / 2.0 + 0.5
        self._delay_corr = 2.0 * np.pi * TONE_HZ * gd / self.fs

    def init_state(self):
        return {"bpf": self.sub_bpf.init_state(), "fm": self.fm.init_state()}

    def __call__(self, state, x):
        st = dict(state)
        env = torch.abs(x).to(torch.float32)
        env = env - torch.mean(env, dim=-1, keepdim=True)

        st["bpf"], sub = self.sub_bpf(state["bpf"], env.to(torch.complex64))
        st["fm"], ref30 = self.fm(state["fm"], sub)

        # identical trimmed windows keep the two bins phase-aligned
        t = self._trim
        var_tone = _single_bin(env[..., t:], TONE_HZ, self.fs)
        ref30 = ref30 - torch.mean(ref30[..., t:], dim=-1, keepdim=True)
        ref_tone = _single_bin(ref30[..., t:], TONE_HZ, self.fs)

        bearing = (torch.angle(var_tone) - torch.angle(ref_tone)
                   - self._delay_corr)
        # floor-mod, as jnp.mod: the result takes the divisor's sign
        bearing_deg = torch.remainder(torch.rad2deg(bearing), 360.0)
        amp = torch.abs(var_tone)
        return st, (bearing_deg, amp)


def synthesize_vor(bearing_deg: float, fs: float = 25000.0,
                   seconds: float = 1.0, mod_depth: float = 0.3) -> np.ndarray:
    """Generate a VOR baseband IQ signal (tests)."""
    t = np.arange(int(fs * seconds)) / fs
    phase = np.deg2rad(bearing_deg)
    var = np.cos(2 * np.pi * TONE_HZ * t + phase)
    ref_fm_phase = (SUB_DEVIATION / TONE_HZ) * np.sin(2 * np.pi * TONE_HZ * t)
    sub = np.cos(2 * np.pi * SUBCARRIER_HZ * t + ref_fm_phase)
    env = 1.0 + mod_depth * var + mod_depth * sub
    return (env * np.exp(2j * np.pi * 0.0 * t)).astype(np.complex64)
