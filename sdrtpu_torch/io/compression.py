"""Sample stream compression — SDR++ server wire format parity (PyTorch
counterpart of ``sdrtpu/io/compression.py``; host code).

Format (``core/src/dsp/compression/sample_stream_compressor.h:30-64``):

    u16 compression_type (0)
    u16 sample_type      (0=i8, 1=i16, 2=f32; ``pcm_type.h``)
    f32 scaler           (max |component|; 0 for f32)
    payload              (interleaved I/Q samples)

The int paths scale by 128/max or 32768/max (matching VOLK's convert
kernels, which saturate).  Optional zstd (level 1, ``server.cpp:235``) is
applied to the whole packet when the ``zstandard`` module or the system
``libzstd`` is available (`HAVE_ZSTD`); without either, the port's server
refuses a client's request for compression instead of ignoring it.
`compress` takes a torch tensor on any device as well as numpy; the bytes
are those of the reference for the same samples.
"""

from __future__ import annotations

import struct

import numpy as np

from ..convert import to_numpy

try:  # optional, matches the reference's optional zstd path
    import zstandard as _zstd

    HAVE_ZSTD = True
except ImportError:
    _zstd = None
    HAVE_ZSTD = False


class _CtypesZstd:
    """One-shot zstd via the system libzstd (ctypes).

    The reference compresses each server packet independently with
    ``ZSTD_compressCCtx`` (``server.cpp:232-246``); one-shot
    compress/decompress is exactly that usage, so binding the C library
    directly gives wire parity without the ``zstandard`` wheel.
    """

    # Ceiling on a frame's declared content size: the header is
    # attacker-controlled network input (server protocol baseband
    # packets), so never allocate what it claims unchecked.  Wire packets
    # are <= a few MB; 256 MB leaves two orders of magnitude of headroom.
    MAX_CONTENT = 256 * 1024 * 1024

    def __init__(self):
        import ctypes
        import ctypes.util

        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        self._ct = ctypes
        self._lib = lib

    def compress(self, data: bytes, level: int = 1) -> bytes:
        ct, lib = self._ct, self._lib
        bound = lib.ZSTD_compressBound(len(data))
        out = ct.create_string_buffer(bound)
        n = lib.ZSTD_compress(out, bound, data, len(data), level)
        if lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress failed")
        return out.raw[:n]

    def decompress(self, data: bytes) -> bytes:
        ct, lib = self._ct, self._lib
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        if size in (2**64 - 1, 2**64 - 2):  # ERROR / UNKNOWN
            raise RuntimeError("zstd frame without content size")
        if int(size) > self.MAX_CONTENT:
            raise RuntimeError(
                f"zstd frame declares {int(size)} bytes "
                f"(> {self.MAX_CONTENT} cap); refusing to allocate"
            )
        out = ct.create_string_buffer(int(size) or 1)
        n = lib.ZSTD_decompress(out, int(size), data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_decompress failed")
        return out.raw[:n]


if not HAVE_ZSTD:  # fall back to the system C library
    try:
        _ctz = _CtypesZstd()
        HAVE_ZSTD = True
    except OSError:  # pragma: no cover
        _ctz = None
else:
    _ctz = None

PCM_TYPE_I8 = 0
PCM_TYPE_I16 = 1
PCM_TYPE_F32 = 2


def compress(iq: np.ndarray, pcm_type: int = PCM_TYPE_I16) -> bytes:
    """complex64 IQ (numpy, or a tensor on any device) -> wire payload
    with scale header."""
    iq = to_numpy(iq)
    interleaved = np.empty(iq.size * 2, np.float32)
    interleaved[0::2] = iq.real
    interleaved[1::2] = iq.imag
    if pcm_type == PCM_TYPE_F32:
        return struct.pack("<HHf", 0, PCM_TYPE_F32, 0.0) + interleaved.tobytes()
    # max |component|.  (The reference's volk_32f_index_max_32u takes the
    # SIGNED max — sample_stream_compressor.h:48-51 — which clips or
    # sign-flips asymmetric/DC-offset basebands.  The wire format is
    # self-describing via the scaler header, so abs-max stays fully
    # compatible with any decompressor while never destroying samples.)
    max_val = float(np.abs(interleaved).max()) if iq.size else 1.0
    if max_val == 0.0:
        max_val = 1.0
    hdr = struct.pack("<HHf", 0, pcm_type, max_val)
    if pcm_type == PCM_TYPE_I8:
        data = np.clip(
            np.rint(interleaved * (128.0 / max_val)), -128, 127
        ).astype(np.int8)
    else:
        data = np.clip(
            np.rint(interleaved * (32768.0 / max_val)), -32768, 32767
        ).astype(np.int16)
    return hdr + data.tobytes()


def decompress(payload: bytes) -> np.ndarray:
    """Wire payload -> complex64 IQ (``sample_stream_decompressor.h``)."""
    _, sample_type, scaler = struct.unpack("<HHf", payload[:8])
    raw = payload[8:]
    if sample_type == PCM_TYPE_F32:
        x = np.frombuffer(raw, np.float32)
    elif sample_type == PCM_TYPE_I8:
        x = np.frombuffer(raw, np.int8).astype(np.float32) * (scaler / 128.0)
    elif sample_type == PCM_TYPE_I16:
        x = np.frombuffer(raw, np.int16).astype(np.float32) * (scaler / 32768.0)
    else:
        raise ValueError(f"unknown sample type {sample_type}")
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def zstd_compress(data: bytes, level: int = 1) -> bytes:
    if _zstd is not None:
        return _zstd.ZstdCompressor(level=level).compress(data)
    if _ctz is not None:
        return _ctz.compress(data, level)
    raise RuntimeError("no zstd available (zstandard module or libzstd)")


def zstd_decompress(data: bytes) -> bytes:
    if _zstd is not None:
        return _zstd.ZstdDecompressor().decompress(data)
    if _ctz is not None:
        return _ctz.decompress(data)
    raise RuntimeError("no zstd available (zstandard module or libzstd)")
