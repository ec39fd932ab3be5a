"""Codec2 vocoder binding (ctypes, system ``libcodec2``; host copy of
``sdrtpu/decoders/codec2.py``).

The reference's m17_decoder links the system codec2 library for voice
synthesis (``decoder_modules/m17_decoder/CMakeLists.txt:27``, used from
``m17dsp.h:8,447-510``).  This module binds the very same library
through ctypes, gated on availability (`Codec2.available()`), so the M17 chain produces
audible audio wherever the reference would.

API used (codec2.h):
    struct CODEC2 *codec2_create(int mode);
    void codec2_destroy(struct CODEC2 *);
    int  codec2_samples_per_frame(struct CODEC2 *);
    int  codec2_bytes_per_frame(struct CODEC2 *);
    void codec2_encode(struct CODEC2 *, unsigned char *bits, short *speech);
    void codec2_decode(struct CODEC2 *, short *speech, const unsigned char *bits);
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# codec2/codec2.h mode constants
MODE_3200 = 0   # M17 stream mode: 64 bits / 20 ms / 160 samples @ 8 kHz
MODE_2400 = 1
MODE_1600 = 2
MODE_1400 = 3
MODE_1300 = 4
MODE_1200 = 5

_LIB_CANDIDATES = ("codec2", "libcodec2.so.1.0", "libcodec2.so.1",
                   "libcodec2.so")


def _load() -> ctypes.CDLL | None:
    name = ctypes.util.find_library("codec2")
    names = ([name] if name else []) + list(_LIB_CANDIDATES[1:])
    for n in names:
        try:
            lib = ctypes.CDLL(n)
        except OSError:
            continue
        lib.codec2_create.restype = ctypes.c_void_p
        lib.codec2_create.argtypes = [ctypes.c_int]
        lib.codec2_destroy.argtypes = [ctypes.c_void_p]
        lib.codec2_samples_per_frame.restype = ctypes.c_int
        lib.codec2_samples_per_frame.argtypes = [ctypes.c_void_p]
        lib.codec2_bytes_per_frame.restype = ctypes.c_int
        lib.codec2_bytes_per_frame.argtypes = [ctypes.c_void_p]
        lib.codec2_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_short),
        ]
        lib.codec2_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
            ctypes.c_char_p,
        ]
        return lib
    return None


_LIB = _load()


class Codec2:
    """One codec2 en/decoder instance (stateful, like the C object)."""

    SAMPLERATE = 8000.0

    def __init__(self, mode: int = MODE_3200):
        if _LIB is None:
            raise RuntimeError(
                "system libcodec2 not found; M17 voice output unavailable "
                "(frame bits are still decoded)"
            )
        self._lib = _LIB
        self._c = _LIB.codec2_create(mode)
        if not self._c:
            raise RuntimeError(f"codec2_create({mode}) failed")
        self.samples_per_frame = _LIB.codec2_samples_per_frame(self._c)
        self.bytes_per_frame = _LIB.codec2_bytes_per_frame(self._c)

    @staticmethod
    def available() -> bool:
        return _LIB is not None

    def __del__(self):
        c = getattr(self, "_c", None)
        if c:
            self._lib.codec2_destroy(c)
            self._c = None

    def decode(self, frames: bytes) -> np.ndarray:
        """Packed codec2 frames -> int16 PCM @ 8 kHz."""
        bpf, spf = self.bytes_per_frame, self.samples_per_frame
        assert len(frames) % bpf == 0, (len(frames), bpf)
        n = len(frames) // bpf
        pcm = np.empty(n * spf, np.int16)
        buf = (ctypes.c_short * spf)()
        for i in range(n):
            self._lib.codec2_decode(
                self._c, buf, frames[i * bpf:(i + 1) * bpf]
            )
            pcm[i * spf:(i + 1) * spf] = np.frombuffer(buf, np.int16)
        return pcm

    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 PCM @ 8 kHz (multiple of samples_per_frame) -> frames."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        bpf, spf = self.bytes_per_frame, self.samples_per_frame
        assert len(pcm) % spf == 0, (len(pcm), spf)
        n = len(pcm) // spf
        out = bytearray()
        bits = ctypes.create_string_buffer(bpf)
        for i in range(n):
            frame = pcm[i * spf:(i + 1) * spf]
            self._lib.codec2_encode(
                self._c, bits,
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            )
            out += bits.raw[:bpf]
        return bytes(out)
