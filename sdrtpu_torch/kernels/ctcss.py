"""CTCSS sub-audible tone squelch and decoder (PyTorch counterpart of
``sdrtpu/kernels/ctcss.py``).

The stereo audio is read as complex (L + jR), brought down by 160.55 Hz
and resampled to 500 S/s, FM-discriminated at a deviation of 1 Hz (so the
output is the instantaneous frequency offset in Hz); a running mean and
variance with a Schmitt trigger on the variance decide whether a stable
tone is present, and the mean maps to the nearest of the 51 standard
tones.

The detector is a state machine at 500 S/s (25 steps per 50 ms block).
It runs as a short loop of torch ops on the op's device, step for step as
the reference; its booleans and its int32 tone are state leaves, so a
host can read them (`RadioChain.ctcss_tone_detected`).  The audio gate
acts on whole blocks from the final mute state.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..graph.block import StreamOp
from .demod import Quadrature
from .mixer import FreqXlator
from .resample import RationalResampler

DECODE_SAMPLERATE = 500.0
DECODE_OFFSET = 160.55

# The 51 standard CTCSS tone frequencies (Hz).
CTCSS_TONES = np.array([
    67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5,
    94.8, 97.4, 100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3,
    131.8, 136.5, 141.3, 146.2, 150.0, 151.4, 156.7, 159.8, 162.2, 165.5,
    167.9, 171.3, 173.8, 177.3, 179.9, 183.5, 186.2, 189.9, 192.8, 196.6,
    199.5, 203.5, 206.5, 210.7, 218.1, 225.7, 229.1, 233.6, 241.8, 250.3,
    254.1,
], dtype=np.float32)

TONE_ANY = -2
TONE_NONE = -1


class CtcssSquelch(StreamOp):
    """Stereo audio gate keyed on a required CTCSS tone.

    ``required_tone``: TONE_NONE (decode only, audio always passes),
    TONE_ANY (any valid tone opens), or an index into `CTCSS_TONES`.
    Output: (gated_audio, detected_tone_index).
    """

    def __init__(self, samplerate: float, required_tone: int = TONE_NONE,
                 device="cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.samplerate = float(samplerate)
        self.required_tone = int(required_tone)
        self.xlator = FreqXlator(-DECODE_OFFSET, samplerate, device=dev)
        self.ddc = RationalResampler(samplerate, DECODE_SAMPLERATE, device=dev)
        self.quad = Quadrature(1.0, DECODE_SAMPLERATE, device=dev)
        self._tones = torch.as_tensor(CTCSS_TONES, device=dev)
        # built once: a host copy on every call cannot be captured
        self._none = torch.tensor(TONE_NONE, dtype=torch.int32, device=dev)

    def block_multiple(self) -> int:
        return self.ddc.block_multiple()

    def init_state(self):
        def leaf(value, dtype):
            return torch.tensor(value, dtype=dtype, device=self.device)

        return {
            "xl": self.xlator.init_state(),
            "ddc": self.ddc.init_state(),
            "quad": self.quad.init_state(),
            "mean": leaf(0.0, torch.float32),
            "var": leaf(1e6, torch.float32),  # start noisy -> muted
            "var_ok": leaf(False, torch.bool),
            "mute": leaf(True, torch.bool),
            "tone": leaf(TONE_NONE, torch.int32),
            "min_freq": leaf(0.0, torch.float32),
            "max_freq": leaf(0.0, torch.float32),
        }

    def _detector_scan(self, carry, freqs):
        tones = self._tones
        last = len(CTCSS_TONES) - 1
        offset = float(np.float32(DECODE_OFFSET))
        none = self._none
        rt = self.required_tone
        mean, var, var_ok, mute, tone, fmin, fmax = carry
        for val in freqs:
            mean = 0.95 * mean + 0.05 * val
            err = val - mean
            var = 0.95 * var + 0.05 * err * err
            nvar_ok = torch.where(var_ok, var < 1100.0, var < 1000.0)

            rematch = nvar_ok & (~var_ok | (mean < fmin) | (mean > fmax))
            freq = mean + offset
            in_range = (freq >= tones[0] - 2.5) & (freq <= tones[-1] + 2.5)
            nearest = torch.argmin((tones - freq).abs()).to(torch.int32)
            new_tone = torch.where(in_range, nearest, none)

            tone = torch.where(rematch, new_tone, tone)
            new_mute = ~((tone == rt) | ((tone != TONE_NONE)
                                         & (rt == TONE_ANY)))
            mute = torch.where(rematch, new_mute, mute)

            # hysteresis band: halfway to the neighbouring tones
            # (`torch.take`: indexing by a 0-d tensor reads it on the host)
            ti = torch.clamp(tone, 0, last).long()
            c0 = torch.take(tones, ti)
            left = torch.where(ti > 0,
                               torch.take(tones, torch.clamp(ti - 1, min=0)),
                               c0 - 2.5)
            right = torch.where(ti < last,
                                torch.take(tones,
                                           torch.clamp(ti + 1, max=last)),
                                c0 + 2.5)
            valid = rematch & (tone != TONE_NONE)
            fmin = torch.where(valid, (left + c0) / 2.0 - offset, fmin)
            fmax = torch.where(valid, (right + c0) / 2.0 - offset, fmax)

            # falling edge of variance-ok -> mute
            edge = ~nvar_ok & var_ok
            mute = mute | edge
            tone = torch.where(edge, none, tone)
            var_ok = nvar_ok
        return mean, var, var_ok, mute, tone, fmin, fmax

    def __call__(self, state, audio):
        """audio: (2, n) float32 stereo at ``samplerate``."""
        st = dict(state)
        z = torch.complex(audio[0], audio[1])
        st["xl"], z = self.xlator(state["xl"], z)
        st["ddc"], z = self.ddc(state["ddc"], z)
        st["quad"], freqs = self.quad(state["quad"], z)

        keys = ("mean", "var", "var_ok", "mute", "tone", "min_freq",
                "max_freq")
        carry = self._detector_scan(tuple(state[k] for k in keys), freqs)
        st.update(zip(keys, carry))

        if self.required_tone != TONE_NONE:
            audio = torch.where(st["mute"], torch.zeros_like(audio), audio)
        return st, (audio, st["tone"])
