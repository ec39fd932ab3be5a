"""Analog TV decoder (PyTorch counterpart of ``sdrtpu/decoders/atv.py``;
``decoder_modules/atv_decoder`` capability).

Block-parallel, as the reference redesigned the per-sample sync loop:

- `AtvVideoDemod` (on the device): AM/VSB envelope -> normalized video
  (sync tip ~ -0.428, white ~ 1.0) from two order statistics of the
  block's envelope;
- `line_phase` / `AtvLineSync` (on the device): the block's average
  line profile localizes the horizontal sync in one argmin, the
  half-level crossing of its leading edge gives the sub-sample phase,
  and lines are gathered by linear interpolation at that phase (the
  previous block's tail is carried);
- `classify_sync`, `detect_field_starts`, `AtvFrameAssembler` and
  `synthesize_atv` (on the host, copied from the reference): per-line
  sync classes, the 16-bit sync history that finds odd and even field
  starts, and the interlaced (576, 768) frames.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_numpy
from ..graph.block import StreamOp

LINE_SIZE = 945        # samples per line at the reference's video rate
SYNC_LEN = 70
SYNC_LEVEL = -0.428
EQUAL_LEN = 35         # equalizing-pulse width (linesync.h:17)
HBLANK_START = 70      # horizontal blanking interval (linesync.h:19-21)
HBLANK_END = 155       # inclusive
ACTIVE_START = 155     # first rendered pixel (main.cpp:230)
ACTIVE_WIDTH = 768
FRAME_HEIGHT = 576     # rendered PAL frame (main.cpp:39)
Y_OFFSET = 34          # first visible ypos (main.cpp:227)


def _percentiles(x: torch.Tensor, qs) -> list[torch.Tensor]:
    """``jnp.percentile(x, q)`` of a 1-D float32 tensor for each q, by
    the same linear rule in float32 (position q/100 * (n - 1), the two
    order statistics around it weighted by its fraction), from one
    sort: no size limit (``torch.quantile`` refuses > 2**24 elements)."""
    s = torch.sort(x).values
    n = s.shape[0]
    out = []
    for q in qs:
        pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
        lo = np.floor(pos)
        hw = np.float32(pos - lo)
        lw = np.float32(np.float32(1.0) - hw)
        lo_i = min(max(int(lo), 0), n - 1)
        hi_i = min(max(int(np.ceil(pos)), 0), n - 1)
        out.append(s[lo_i] * float(lw) + s[hi_i] * float(hw))
    return out


class AtvVideoDemod(StreamOp):
    """IQ -> normalized video: envelope scaled so sync tip ~ SYNC_LEVEL."""

    def init_state(self):
        return ()

    def __call__(self, state, x):
        env = torch.abs(x).to(torch.float32)
        # sync tips (lowest ~0.5 % of samples), white level
        lo, hi = _percentiles(env.reshape(-1), (0.5, 99.0))
        video = (env - lo) / torch.clamp(hi - lo, min=1e-9)
        video = video * (1.0 - SYNC_LEVEL) + SYNC_LEVEL
        return state, video


def line_phase(video: torch.Tensor, line_size: int = LINE_SIZE,
               sync_len: int = SYNC_LEN) -> torch.Tensor:
    """Sub-sample phase of the horizontal sync within a line (float32,
    0-d, on ``video``'s device).

    Folds the block modulo ``line_size``, averages, and finds the
    sync-length moving-average minimum over the circular profile; the
    sub-sample refinement is the half-level crossing of the LEADING sync
    edge on the averaged profile (the classical video timing point).
    """
    dev = video.device
    n = video.shape[-1] // line_size * line_size
    prof = video[:n].reshape(-1, line_size).mean(dim=0)
    prof2 = torch.cat([prof, prof[:sync_len]])
    # moving average via cumsum (float32, as the reference)
    cs = torch.cat([torch.zeros(1, dtype=prof.dtype, device=dev),
                    torch.cumsum(prof2, 0)])
    ma = (cs[sync_len:] - cs[:-sync_len]) / sync_len  # start positions
    ma = ma[:line_size]
    p = torch.argmin(ma)  # first index on ties; pulse starts near p
    # local profile around the leading edge (circular gather)
    offs = torch.arange(-8, 8, device=dev)
    a = prof[(p + offs) % line_size]  # a[k] = prof[p - 8 + k]
    blank = torch.mean(a[0:5])        # offs -8..-4: porch before the edge
    sync = torch.mean(a[10:15])       # offs  2..6: inside the pulse
    mid = 0.5 * (blank + sync)
    left = a[:-1]
    right = a[1:]
    falling = (left >= mid) & (right < mid)
    k = torch.argmax(falling.to(torch.int32))  # first crossing
    frac = (left[k] - mid) / torch.clamp(left[k] - right[k], min=1e-9)
    delta = (k.to(torch.float32) - 8.0) + frac + 0.5
    # without a clean edge (all-sync/all-blank pathologies) keep the
    # coarse argmin
    delta = torch.where(torch.any(falling), torch.clamp(delta, -2.0, 2.0),
                        torch.zeros_like(delta))
    return p.to(torch.float32) + delta


class AtvLineSync(StreamOp):
    """Video samples -> (lines, line_size) image rows, sub-sample aligned.

    Block length must be a multiple of ``line_size``; the previous tail is
    carried so consecutive blocks stay aligned.  Rows are gathered with
    linear interpolation at the estimated fractional sync phase.
    """

    def __init__(self, line_size: int = LINE_SIZE, device="cuda"):
        self.device = resolve_device(device)
        self.line_size = line_size

    def init_state(self):
        # carry: the previous block's tail
        return torch.zeros(self.line_size, dtype=torch.float32,
                           device=self.device)

    def out_len(self, n: int) -> int:
        assert n % self.line_size == 0
        return n // self.line_size

    def __call__(self, state, video):
        n = video.shape[-1]
        ext = torch.cat([state, video])
        phase = line_phase(video, self.line_size)  # float32, sub-sample
        rows = n // self.line_size
        pos = phase + torch.arange(rows * self.line_size, dtype=torch.float32,
                                   device=video.device)
        i0 = torch.floor(pos).to(torch.int32)
        frac = pos - i0.to(torch.float32)
        m = n + self.line_size
        # CLAMP (not wrap): a refined phase slightly outside [0, line)
        # repeats the edge sample instead of aliasing the block's other
        # end into the first pixel
        i0 = torch.clamp(i0, 0, m - 2).to(torch.int64)
        a = ext[i0]
        b = ext[i0 + 1]
        lines = (a * (1.0 - frac) + b * frac).reshape(rows, self.line_size)
        return ext[-self.line_size:], lines


def detect_field_starts(lines, frac: float = 0.6) -> np.ndarray:
    """Indices of lines inside vertical blanking (mostly at sync level)."""
    lv = to_numpy(lines)
    dark = (lv < SYNC_LEVEL / 2).mean(axis=1)
    return np.where(dark > frac)[0]


def classify_sync(lines) -> np.ndarray:
    """Per-line sync type: 0 = normal, 1 = short (equalizing), 2 = long.

    The reference's classifier (``atv_decoder/src/main.cpp:164-166``):
    with L = mean of the first EQUAL_LEN samples, R = mean of the rest of
    the sync window, B = mean of the horizontal blanking interval,

        short: L < SYNC_LEVEL/2, R > SYNC_LEVEL/2, B > SYNC_LEVEL/2
        long:  L < SYNC_LEVEL/2, R < SYNC_LEVEL/2, B < SYNC_LEVEL/2
    """
    lv = to_numpy(lines).astype(np.float32, copy=False)
    L = lv[:, :EQUAL_LEN].mean(axis=1)
    R = lv[:, EQUAL_LEN:SYNC_LEN].mean(axis=1)
    B = lv[:, HBLANK_START:HBLANK_END + 1].mean(axis=1)
    half = 0.5 * SYNC_LEVEL
    short = (L < half) & (R > half) & (B > half)
    long_ = (L < half) & (R < half) & (B < half)
    return (short.astype(np.uint8) + 2 * long_.astype(np.uint8))


# 8-line sync histories marking a field start, two bits per line
# (``main.cpp:242-244``); the odd and even patterns differ because the
# vertical-sync pulse train is offset by half a line between fields.
SYNC_TO_ODD = 0b0101011010010101
SYNC_TO_EVEN = 0b0001011010100101


class AtvFrameAssembler:
    """Streaming lines -> interlaced PAL frames with field parity (the
    reference's host port of ``atv_decoder/src/main.cpp:236-280``): a
    16-bit rolling history of 2-bit sync codes against the odd/even
    field signatures, 625-line rollover as flywheel, odd fields on rows
    1, 3, 5, ... and even fields on rows 0, 2, 4, ... of a (576, 768)
    frame emitted when the even field starts; ``vlock`` as the
    reference's vertical-lock indicator."""

    def __init__(self):
        self.frame = np.zeros((FRAME_HEIGHT, ACTIVE_WIDTH), np.float32)
        self.history = 0
        self.ypos = 0
        self.line = 0
        self.vlock = 0
        self.frames: list[np.ndarray] = []

    def process(self, lines) -> list[np.ndarray]:
        """Feed (rows, LINE_SIZE) sync-aligned lines (numpy, or a tensor
        on any device); returns any frames completed during this call."""
        lines = to_numpy(lines).astype(np.float32, copy=False)
        codes = classify_sync(lines)
        out: list[np.ndarray] = []
        for row, code in zip(lines, codes):
            self.history = ((self.history << 2) | int(code)) & 0xFFFF
            if Y_OFFSET <= self.ypos <= Y_OFFSET + FRAME_HEIGHT - 1:
                px = row[ACTIVE_START:ACTIVE_START + ACTIVE_WIDTH]
                self.frame[self.ypos - Y_OFFSET] = np.clip(px, 0.0, 1.0)
            roll_odd = self.ypos == 624
            roll_even = self.ypos == 623
            sync_odd = self.history == SYNC_TO_ODD
            sync_even = self.history == SYNC_TO_EVEN
            if roll_odd or sync_odd:
                self._lock(roll_odd ^ sync_odd)
                self.ypos = 1
                self.line += 1
            elif roll_even or sync_even:
                self._lock(roll_even ^ sync_even)
                self.ypos = 0
                self.line = 0
                out.append(self.frame.copy())
            else:
                self.ypos += 2
                self.line += 1
        self.frames += out
        return out

    def _lock(self, disagree: bool) -> None:
        if disagree and self.vlock > 0:
            self.vlock -= 1
        elif not disagree and self.vlock < 20:
            self.vlock += 1


def synthesize_atv(image: np.ndarray, line_size: int = LINE_SIZE,
                   sync_len: int = SYNC_LEN) -> np.ndarray:
    """Build a baseband ATV IQ signal from a grayscale image (tests)."""
    rows, _ = image.shape
    active = line_size - sync_len - 30
    out = np.zeros((rows, line_size), np.float32)
    out[:, :sync_len] = SYNC_LEVEL
    out[:, sync_len : sync_len + 30] = 0.0  # back porch
    for r in range(rows):
        px = np.interp(
            np.linspace(0, image.shape[1] - 1, active),
            np.arange(image.shape[1]),
            image[r],
        )
        out[r, sync_len + 30 :] = px
    video = out.reshape(-1)
    # AM: envelope = (video - SYNC_LEVEL) scaled to [0.05, 1]
    env = (video - SYNC_LEVEL) / (1.0 - SYNC_LEVEL) * 0.95 + 0.05
    return env.astype(np.complex64)
