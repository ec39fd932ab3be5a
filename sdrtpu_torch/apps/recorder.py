"""Recorder (PyTorch counterpart of ``sdrtpu/apps/recorder.py``;
``misc_modules/recorder`` capability; host code).

Records demodulated audio or raw baseband to WAV with SDR++-style filename
templates ($YEAR/$MONTH/.../$FREQ etc., ``recorder/src/main.cpp:44-184``),
silence skipping and a peak meter.  Feed blocks from receiver sinks.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from ..convert import to_numpy
from ..io import wav


def expand_template(template: str, freq_hz: float, now=None) -> str:
    now = now or datetime.datetime.now()
    repl = {
        "$TYPE": "audio",
        "$YEAR": f"{now.year:04d}",
        "$MONTH": f"{now.month:02d}",
        "$DAY": f"{now.day:02d}",
        "$HOUR": f"{now.hour:02d}",
        "$MIN": f"{now.minute:02d}",
        "$SEC": f"{now.second:02d}",
        "$FREQ": f"{int(freq_hz)}Hz",
    }
    out = template
    for k, v in repl.items():
        out = out.replace(k, v)
    return out


class Recorder:
    """Streaming WAV recorder with silence skip and peak metering."""

    def __init__(
        self,
        path: str,
        samplerate: int,
        mode: str = "audio",  # "audio" (stereo f32 blocks) | "baseband" (IQ)
        sample_type: str = "int16",
        ignore_silence: bool = False,
        silence_threshold: float = 1e-4,
    ):
        self.path = path
        self.samplerate = samplerate
        self.mode = mode
        self.sample_type = sample_type
        self.ignore_silence = ignore_silence
        self.silence_threshold = silence_threshold
        self._writer: wav.WavWriter | None = None
        self.peak = 0.0
        self.recorded_samples = 0

    def _open(self, channels: int) -> wav.WavWriter:
        if self._writer is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._writer = wav.WavWriter(
                self.path, self.samplerate, channels, self.sample_type
            )
        return self._writer

    def push(self, block: np.ndarray) -> None:
        """Stream one block to disk (incremental write: long recordings
        must not accumulate in RAM — baseband at 10 Msps is ~80 MB/s)."""
        block = to_numpy(block)
        amp = float(np.max(np.abs(block))) if block.size else 0.0
        self.peak = max(self.peak * 0.85, amp)  # decaying peak meter
        if self.ignore_silence and amp < self.silence_threshold:
            return
        if block.size == 0:
            return
        if self.mode == "audio":
            frames = np.atleast_2d(block).T  # (2, n) -> (n, 2)
            self._open(frames.shape[1]).append(frames)
        else:
            self._open(2).append_iq(block.astype(np.complex64))
        self.recorded_samples += block.shape[-1]

    def close(self) -> str:
        if self._writer is None:
            # nothing was pushed: still produce a valid empty stereo file
            self._open(2)
        w = self._writer
        self._writer = None
        w.close()
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
