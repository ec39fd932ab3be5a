"""WAV / RIFF IQ and audio file IO.

Parity with the reference's ``core/src/utils/{wav,riff}.{h,cpp}`` and the
``file_source`` module (``source_modules/file_source/src/main.cpp``):

- sample formats: uint8, int16, int32, float32 (WAVE_FORMAT_IEEE_FLOAT)
- stereo IQ convention: channel 0 = I, channel 1 = Q
- int samples normalize to [-1, 1) on read (the file_source does int16/32768
  style scaling via VOLK; we divide by the type's full scale)
- ``center_freq_from_name`` parses the capture frequency out of SDR++-style
  recording filenames (``file_source/src/main.cpp:183-190``: the first
  integer-looking token of >= 6 digits is taken as Hz).

Pure NumPy on the host — this is the ingest edge; device transfer happens in
the framing layer.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass

import numpy as np

_FMT_PCM = 1
_FMT_IEEE_FLOAT = 3

_DTYPES = {
    (_FMT_PCM, 8): np.uint8,
    (_FMT_PCM, 16): np.int16,
    (_FMT_PCM, 32): np.int32,
    (_FMT_IEEE_FLOAT, 32): np.float32,
}


@dataclass
class WavInfo:
    samplerate: int
    channels: int
    bits_per_sample: int
    format: int
    frames: int


def read_wav(path: str) -> tuple[WavInfo, np.ndarray]:
    """Read a WAV file -> (info, float32 array shaped (frames, channels)).

    Integer formats are scaled to [-1, 1).  Walks RIFF chunks explicitly so
    nonstandard chunks (e.g. 'auxi' metadata some SDR recorders emit) are
    skipped, like the reference's riff reader.
    """
    with open(path, "rb") as f:
        riff, size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, samplerate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    key = (audio_fmt, bits)
    if key not in _DTYPES:
        raise ValueError(f"{path}: unsupported format {audio_fmt}/{bits}-bit")
    raw = np.frombuffer(data, dtype=_DTYPES[key])
    frames = len(raw) // channels
    raw = raw[: frames * channels].reshape(frames, channels)
    if raw.dtype == np.uint8:
        out = (raw.astype(np.float32) - 128.0) / 128.0
    elif raw.dtype == np.int16:
        out = raw.astype(np.float32) / 32768.0
    elif raw.dtype == np.int32:
        out = raw.astype(np.float32) / 2147483648.0
    else:
        out = raw.astype(np.float32)
    info = WavInfo(samplerate, channels, bits, audio_fmt, frames)
    return info, out


def read_iq_wav(path: str) -> tuple[WavInfo, np.ndarray]:
    """Read a 2-channel IQ WAV into complex64 (I + jQ)."""
    info, x = read_wav(path)
    if info.channels != 2:
        raise ValueError(f"{path}: IQ WAV must have 2 channels, got {info.channels}")
    return info, (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def write_wav(
    path: str, samplerate: int, samples: np.ndarray, sample_type: str = "int16"
) -> None:
    """Write (frames,) or (frames, channels) float data to WAV.

    ``sample_type``: one of uint8 / int16 / int32 / float32, matching the
    recorder module's selectable formats (``misc_modules/recorder``).
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]
    data, fmt, bits = _convert_samples(x, sample_type)
    payload = data.tobytes()
    byte_rate = samplerate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(
            struct.pack(
                "<4sIHHIIHH",
                b"fmt ",
                16,
                fmt,
                channels,
                samplerate,
                byte_rate,
                block_align,
                bits,
            )
        )
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def write_iq_wav(
    path: str, samplerate: int, iq: np.ndarray, sample_type: str = "int16"
) -> None:
    """Write complex IQ as a 2-channel WAV (I=left, Q=right)."""
    x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    write_wav(path, samplerate, x, sample_type)


def _convert_samples(x: np.ndarray, sample_type: str):
    """float frames -> (encoded array, wave fmt code, bits/sample)."""
    if sample_type == "uint8":
        return (np.clip(x, -1, 1) * 127.0 + 128.0).astype(np.uint8), _FMT_PCM, 8
    if sample_type == "int16":
        return (np.clip(x, -1, 1) * 32767.0).astype(np.int16), _FMT_PCM, 16
    if sample_type == "int32":
        return (
            (np.clip(x, -1, 1) * 2147483647.0).astype(np.int32), _FMT_PCM, 32
        )
    if sample_type == "float32":
        return x.astype(np.float32), _FMT_IEEE_FLOAT, 32
    raise ValueError(f"unknown sample_type {sample_type}")


class WavWriter:
    """Incremental WAV writer: append frames as they arrive.

    The RIFF/data chunk sizes are patched on ``close()``, so arbitrarily
    long recordings stream to disk instead of accumulating in RAM (a
    10 Msps baseband capture is ~80 MB/s — the recorder must not buffer
    it; the reference also writes incrementally, ``riff.cpp``).
    """

    def __init__(self, path: str, samplerate: int, channels: int,
                 sample_type: str = "int16"):
        self.path = path
        self.sample_type = sample_type
        self.channels = int(channels)
        _, fmt, bits = _convert_samples(np.zeros((0, channels)), sample_type)
        self._f = open(path, "wb")
        byte_rate = samplerate * channels * bits // 8
        block_align = channels * bits // 8
        self._f.write(struct.pack("<4sI4s", b"RIFF", 36, b"WAVE"))
        self._f.write(struct.pack(
            "<4sIHHIIHH", b"fmt ", 16, fmt, self.channels, int(samplerate),
            byte_rate, block_align, bits,
        ))
        self._f.write(struct.pack("<4sI", b"data", 0))
        self._data_bytes = 0

    def append(self, samples: np.ndarray) -> None:
        """Append (frames,) or (frames, channels) float data."""
        x = np.asarray(samples)
        if x.ndim == 1:
            x = x[:, None]
        assert x.shape[1] == self.channels, (x.shape, self.channels)
        data, _, _ = _convert_samples(x, self.sample_type)
        b = data.tobytes()
        self._f.write(b)
        self._data_bytes += len(b)

    def append_iq(self, iq: np.ndarray) -> None:
        """Append complex IQ (2-channel convention: I=left, Q=right)."""
        self.append(np.stack([iq.real, iq.imag], axis=1).astype(np.float32))

    def close(self) -> str:
        f = self._f
        if f is not None:
            self._f = None
            f.seek(4)
            f.write(struct.pack("<I", 36 + self._data_bytes))
            f.seek(40)
            f.write(struct.pack("<I", self._data_bytes))
            f.close()
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


_FREQ_RE = re.compile(r"(\d{6,})")


def center_freq_from_name(filename: str) -> float | None:
    """Parse center frequency (Hz) from an SDR++-style recording filename."""
    m = _FREQ_RE.search(filename)
    return float(m.group(1)) if m else None
