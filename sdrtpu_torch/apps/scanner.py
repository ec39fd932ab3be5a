"""Frequency scanner (PyTorch counterpart of ``sdrtpu/apps/scanner.py``;
``misc_modules/scanner`` capability; host code).

Sweeps a frequency range, watching the latest FFT line for energy above a
threshold within the (virtual) VFO bandwidth; on detection it dwells until
the signal disappears for ``linger_time`` (``scanner/src/main.cpp:128-210``).

Instead of the GUI waterfall, the scanner consumes dB spectra from the
port's `kernels.fftspec.SpectrumAnalyzer` / `apps.waterfall.WaterfallView`
(numpy, or a tensor on any device, converted at the boundary) and
drives a ``tune_callback`` (the SourceManager analog).  Time advances with
the spectra that are pushed in — deterministic and testable, no 10 Hz
thread.
"""

from __future__ import annotations

import numpy as np

from ..convert import to_numpy


class Scanner:
    def __init__(
        self,
        start_freq: float,
        stop_freq: float,
        interval: float = 10e3,
        vfo_bandwidth: float = 12.5e3,
        level_db: float = -50.0,
        linger_time: float = 0.5,
        tuning_time: float = 0.25,
        tune_callback=None,
        scan_up: bool = True,
    ):
        self.start_freq = start_freq
        self.stop_freq = stop_freq
        self.interval = interval
        self.vfo_bandwidth = vfo_bandwidth
        self.level_db = level_db
        self.linger_time = linger_time
        self.tuning_time = tuning_time
        self.tune_callback = tune_callback
        self.scan_up = scan_up

        self.current = start_freq
        self.receiving = False
        self._tuning_left = 0.0
        self._linger_left = 0.0
        self._tune(self.current)

    def _tune(self, freq: float):
        self.current = freq
        self._tuning_left = self.tuning_time
        if self.tune_callback:
            self.tune_callback(freq)

    def _max_level(self, line, center, width, wf_start, wf_bandwidth):
        n = len(line)
        lo = int(np.clip((center - width / 2 - wf_start) / wf_bandwidth * n, 0, n))
        hi = int(np.clip((center + width / 2 - wf_start) / wf_bandwidth * n, 0, n))
        if hi <= lo:
            return -np.inf
        return float(np.max(line[lo:hi]))

    def push_spectrum(
        self, line: np.ndarray, wf_center: float, wf_bandwidth: float, dt: float
    ) -> None:
        """Advance the scan state with a new FFT line covering
        [wf_center - bw/2, wf_center + bw/2] and elapsed time dt."""
        line = to_numpy(line)
        wf_start = wf_center - wf_bandwidth / 2
        if self._tuning_left > 0:
            self._tuning_left -= dt
            return

        if self.receiving:
            lvl = self._max_level(
                line, self.current, self.vfo_bandwidth, wf_start, wf_bandwidth
            )
            if lvl >= self.level_db:
                self._linger_left = self.linger_time
            else:
                self._linger_left -= dt
                if self._linger_left <= 0:
                    self.receiving = False
            return

        # seek: check candidate frequencies in scan direction within view
        freqs = []
        f = self.current
        step = self.interval if self.scan_up else -self.interval
        for _ in range(int(wf_bandwidth / self.interval) + 1):
            f += step
            if f > self.stop_freq:
                f = self.start_freq
            if f < self.start_freq:
                f = self.stop_freq
            if abs(f - wf_center) > wf_bandwidth / 2:
                break
            freqs.append(f)
        for f in freqs:
            lvl = self._max_level(
                line, f, self.vfo_bandwidth, wf_start, wf_bandwidth
            )
            if lvl >= self.level_db:
                self.receiving = True
                self._linger_left = self.linger_time
                self._tune(f)
                return
        # nothing visible: jump ahead
        nxt = freqs[-1] + step if freqs else self.current + step
        if nxt > self.stop_freq:
            nxt = self.start_freq
        if nxt < self.start_freq:
            nxt = self.stop_freq
        self._tune(nxt)
