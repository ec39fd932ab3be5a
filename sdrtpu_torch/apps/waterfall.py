"""Waterfall view: host-side spectrum ring, zoom, palette, SNR.

The capability surface of the reference's waterfall widget
(``core/src/gui/widgets/waterfall.cpp``) re-exposed as arrays instead of
pixels:

- ring buffer of raw dB FFT lines (``pushFFT``),
- max-decimation zoom into a view window (``doZoom`` at
  ``waterfall.cpp:65-90``),
- palette mapping to RGBA using SDR++-format colormap JSON
  (``updatePallette`` / ``root/res/colormaps``) — a built-in default
  gradient is generated procedurally,
- exponential FFT smoothing and FFT-hold (``waterfall.cpp:906-918,940``),
- per-VFO strength/SNR estimation (``calculateVFOSignalInfo``
  ``waterfall.cpp:558-597``): peak inside the VFO band vs the average of
  the sidebands one bandwidth out.

All NumPy: this consumes the device-computed dB spectra from
`kernels.fftspec.SpectrumAnalyzer`.
"""

from __future__ import annotations

import json

import numpy as np

WATERFALL_RESOLUTION = 1000


def _default_colormap() -> np.ndarray:
    """Procedural dark-blue -> white -> hot default gradient (RGB 0-255)."""
    anchors = np.array(
        [
            (0, 0, 32),
            (0, 0, 96),
            (30, 144, 255),
            (255, 255, 255),
            (255, 255, 0),
            (255, 80, 0),
            (180, 0, 0),
        ],
        dtype=np.float64,
    )
    x = np.linspace(0, len(anchors) - 1, 256)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, len(anchors) - 1)
    frac = (x - lo)[:, None]
    return (anchors[lo] * (1 - frac) + anchors[hi] * frac).astype(np.float64)


def load_colormap(path: str) -> np.ndarray:
    """Load an SDR++-format colormap JSON ({"map": ["#rrggbb", ...]})."""
    with open(path) as f:
        data = json.load(f)
    colors = [
        tuple(int(h.lstrip("#")[i : i + 2], 16) for i in (0, 2, 4))
        for h in data["map"]
    ]
    return np.asarray(colors, np.float64)


def build_palette(colors: np.ndarray, resolution: int = WATERFALL_RESOLUTION):
    """Interpolate colormap anchors into an RGBA LUT (``updatePallette``)."""
    n = len(colors)
    i = np.arange(resolution, dtype=np.float64)
    pos = i / resolution * n
    lo = np.clip(np.floor(pos).astype(int), 0, n - 1)
    hi = np.clip(np.ceil(pos).astype(int), 0, n - 1)
    ratio = (pos - lo)[:, None]
    rgb = colors[lo] * (1 - ratio) + colors[hi] * ratio
    lut = np.empty((resolution, 4), np.uint8)
    lut[:, :3] = np.round(rgb).astype(np.uint8)
    lut[:, 3] = 255
    return lut


def do_zoom(line: np.ndarray, offset: int, width: int, out_size: int) -> np.ndarray:
    """Max-decimation zoom (``doZoom`` parity), vectorized."""
    in_size = len(line)
    offset = max(offset, 0)
    width = min(width, 524288)
    factor = width / out_size
    s_factor = int(np.ceil(factor))
    starts = (offset + np.arange(out_size) * factor).astype(int)
    idx = starts[:, None] + np.arange(s_factor)[None, :]
    valid = idx < in_size
    idx = np.minimum(idx, in_size - 1)
    vals = np.where(valid, line[idx], -np.inf)
    return vals.max(axis=1)


def vfo_signal_info(
    fft_line: np.ndarray,
    center_offset: float,
    bandwidth: float,
    whole_bandwidth: float,
) -> tuple[float, float]:
    """(strength dBFS, SNR dB) per ``calculateVFOSignalInfo``."""
    n = len(fft_line)
    half = n // 2

    def to_idx(freq):
        return int(np.clip(freq / (whole_bandwidth / 2.0) * half + half, 0, n))

    lo_side = to_idx(center_offset - bandwidth)
    lo = to_idx(center_offset - bandwidth / 2.0)
    hi = to_idx(center_offset + bandwidth / 2.0)
    hi_side = to_idx(center_offset + bandwidth)

    side = np.concatenate([fft_line[lo_side:lo], fft_line[hi + 1 : hi_side]])
    avg = side.mean() if len(side) else -np.inf
    peak = fft_line[lo : hi + 1].max() if hi >= lo else -np.inf
    return float(peak), float(peak - avg)


class WaterfallView:
    """Raw-FFT ring + rendered waterfall framebuffer."""

    def __init__(
        self,
        fft_size: int,
        height: int = 512,
        view_width: int = 1024,
        wf_min: float = -70.0,
        wf_max: float = 0.0,
        colormap: np.ndarray | None = None,
        smoothing_alpha: float | None = None,
        hold_speed: float | None = None,
    ):
        self.fft_size = fft_size
        self.height = height
        self.view_width = view_width
        self.wf_min = wf_min
        self.wf_max = wf_max
        self.raw = np.full((height, fft_size), -200.0, np.float32)
        self.fb = np.zeros((height, view_width, 4), np.uint8)
        self.palette = build_palette(
            colormap if colormap is not None else _default_colormap()
        )
        self.view_offset = 0
        self.view_size = fft_size
        self.latest = np.full(view_width, -np.inf, np.float32)
        self.smoothing_alpha = smoothing_alpha
        self._smooth = None
        self.hold_speed = hold_speed
        self.hold = None

    def set_view(self, offset: int, size: int) -> None:
        self.view_offset = int(np.clip(offset, 0, self.fft_size - 1))
        self.view_size = int(np.clip(size, 1, self.fft_size - self.view_offset))

    def push(self, db_lines: np.ndarray) -> None:
        """Append (frames, fft_size) dB lines; update fb and latest line.

        Readers (webview HTTP threads) snapshot ``fb``/``raw``/``latest``
        without locks, so every update builds the NEW array fully and
        only then rebinds the attribute — never mutates a published one.
        """
        for line in np.atleast_2d(db_lines):
            raw = np.roll(self.raw, 1, axis=0)
            raw[0] = line
            self.raw = raw
            zoomed = do_zoom(
                line, self.view_offset, self.view_size, self.view_width
            )
            if self.smoothing_alpha is not None:
                if self._smooth is None:
                    self._smooth = zoomed.copy()
                self._smooth = (
                    self.smoothing_alpha * zoomed
                    + (1 - self.smoothing_alpha) * self._smooth
                )
                zoomed = self._smooth
            self.latest = zoomed.astype(np.float32)
            if self.hold_speed is not None:
                if self.hold is None:
                    self.hold = self.latest.copy()
                self.hold = np.maximum(self.latest, self.hold - self.hold_speed)
            pix = np.clip(
                (zoomed - self.wf_min) / (self.wf_max - self.wf_min), 0.0, 1.0
            )
            ids = (pix * (len(self.palette) - 1)).astype(int)
            fb = np.roll(self.fb, 1, axis=0)
            fb[0] = self.palette[ids]
            self.fb = fb

    def latest_raw(self) -> np.ndarray:
        """Most recent raw FFT line (scanner's ``acquireLatestFFT``)."""
        return self.raw[0]


def save_waterfall_png(path: str, db_lines: np.ndarray,
                       colormap: np.ndarray | None = None,
                       wf_min: float = -70.0, wf_max: float = 0.0,
                       width: int = 1024) -> None:
    """Render dB frames to a PNG (the waterfall widget as a file).

    The reference renders this texture live in the GUI
    (``waterfall.cpp:944-956`` palette LUT); headless users get the same
    image from recorded spectra.
    """
    from PIL import Image

    lines = np.atleast_2d(np.asarray(db_lines, np.float32))
    view = WaterfallView(lines.shape[1], height=lines.shape[0],
                         view_width=width, wf_min=wf_min, wf_max=wf_max,
                         colormap=colormap)
    # stream order in: each push rolls the newer line to row 0, so after
    # pushing oldest->newest the NEWEST frame is at the top — matching
    # the live WaterfallView orientation
    view.push(lines)
    Image.fromarray(view.fb, "RGBA").save(path)
