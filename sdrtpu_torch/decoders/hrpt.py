"""NOAA HRPT deframer (PyTorch counterpart of ``sdrtpu/decoders/hrpt.py``;
``decoder_modules/weather_sat_decoder`` capability).

Host code, copied from the reference as it is; `HrptDeframer.process`
takes a numpy array or a tensor of bits on any device.

Note: the reference module references DSP headers that do not exist in the
snapshot (``dsp/deframing.h``, ``dsp/noaa/hrpt.h``) — it cannot build.
This implementation follows the public NOAA KLM HRPT format instead:

- minor frame: 11090 ten-bit words, transmitted MSB first,
- frame sync: the first 6 words 0x0284 0x016F 0x035C 0x019D 0x020F 0x0095
  (60 bits),
- AVHRR video: 10240 words starting at word 750 — 2048 pixels x 5
  spectral channels, channel-interleaved.

`HrptDeframer` consumes hard bits (post Manchester decode — use
`kernels.digital.ManchesterDecoder` upstream for the split-phase HRPT
downlink) and emits complete 11090-word frames; `avhrr_lines` splits a
frame into the five 2048-pixel image lines.
"""

from __future__ import annotations

import numpy as np

from ..convert import to_numpy

SYNC_WORDS = (0x0284, 0x016F, 0x035C, 0x019D, 0x020F, 0x0095)
WORDS_PER_FRAME = 11090
BITS_PER_WORD = 10
FRAME_BITS = WORDS_PER_FRAME * BITS_PER_WORD
AVHRR_OFFSET = 750
AVHRR_PIXELS = 2048
AVHRR_CHANNELS = 5

SYNC_BITS = np.array(
    [(w >> (BITS_PER_WORD - 1 - i)) & 1 for w in SYNC_WORDS for i in range(BITS_PER_WORD)],
    np.uint8,
)


def pack_words(bits: np.ndarray) -> np.ndarray:
    """(n*10,) bits -> (n,) uint16 ten-bit words (MSB first)."""
    b = np.asarray(bits, np.uint8).reshape(-1, BITS_PER_WORD)
    weights = (1 << np.arange(BITS_PER_WORD - 1, -1, -1)).astype(np.uint16)
    return (b * weights).sum(axis=1).astype(np.uint16)


def unpack_words(words: np.ndarray) -> np.ndarray:
    w = np.asarray(words, np.uint16)[:, None]
    shifts = np.arange(BITS_PER_WORD - 1, -1, -1)
    return ((w >> shifts) & 1).astype(np.uint8).reshape(-1)


class HrptDeframer:
    """Bit stream -> complete 11090-word frames (sync tolerance settable)."""

    def __init__(self, max_sync_errors: int = 4):
        self.max_sync_errors = max_sync_errors
        self._bits: list[int] = []
        self.frames: list[np.ndarray] = []

    def process(self, bits: np.ndarray) -> list[np.ndarray]:
        self._bits.extend(
            int(b) for b in to_numpy(bits).astype(np.uint8, copy=False))
        new = []
        buf = self._bits
        i = 0
        n_sync = len(SYNC_BITS)
        while i + FRAME_BITS <= len(buf):
            cand = np.asarray(buf[i : i + n_sync], np.uint8)
            if np.count_nonzero(cand != SYNC_BITS) <= self.max_sync_errors:
                frame_bits = np.asarray(buf[i : i + FRAME_BITS], np.uint8)
                frame = pack_words(frame_bits)
                new.append(frame)
                self.frames.append(frame)
                i += FRAME_BITS
            else:
                i += 1
        del buf[:i]
        return new


def avhrr_lines(frame: np.ndarray) -> np.ndarray:
    """Frame words -> (5, 2048) uint16 AVHRR image lines."""
    video = np.asarray(frame, np.uint16)[
        AVHRR_OFFSET : AVHRR_OFFSET + AVHRR_PIXELS * AVHRR_CHANNELS
    ]
    return video.reshape(AVHRR_PIXELS, AVHRR_CHANNELS).T


def build_frame(avhrr: np.ndarray | None = None, fill: int = 0x155) -> np.ndarray:
    """Synthesize a frame (tests/tx): sync + fill + optional AVHRR data."""
    frame = np.full(WORDS_PER_FRAME, fill, np.uint16)
    frame[: len(SYNC_WORDS)] = SYNC_WORDS
    if avhrr is not None:
        a = np.asarray(avhrr, np.uint16)
        assert a.shape == (AVHRR_CHANNELS, AVHRR_PIXELS)
        frame[AVHRR_OFFSET : AVHRR_OFFSET + AVHRR_PIXELS * AVHRR_CHANNELS] = (
            a.T.reshape(-1)
        )
    return frame
