"""Native host-side IO library (C++, ctypes-bound), the port's own copy of
``sdrtpu/native``.

- `convert_to_planar(data, fmt)`: interleaved u8/i8/i16/i32/f32 wire IQ
  -> planar (re, im) float32.
- `convert_from_planar(re, im, fmt)`: the reverse, for egress.
- `SpscRing`: lock-free single-producer single-consumer byte ring.
- `NativeTcpPump`: a C++ reader thread draining a connected socket into
  the ring (no interpreter lock on the wire path); whole samples only,
  overruns dropped and counted.

The library builds with g++ (the reference's flags) from
``native/src/*.cpp`` on first use, into ``build/sdrtpu_torch/`` beside
the package, named by a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing builds
at import.  Without a toolchain `get_lib` returns None: the conversions
then run the reference's NumPy versions, `SpscRing` a single-threaded
shim, and `NativeTcpPump` raises (`io.net.NetworkSource` records which
reader served each connection).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sdrtpu_torch"
SOURCES = ("iqconvert.cpp", "ringbuffer.cpp", "ingest.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def lib_path() -> Path:
    """Where the library of these sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_SRC / name).read_bytes())
    return BUILD_DIR / f"libsdrtpu_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    with g++'s output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *(str(_SRC / s) for s in SOURCES), "-o",
           str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib():
    """The loaded native library, built on first use; None when it
    cannot be built or loaded here (logged once)."""
    try:
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
    except (OSError, RuntimeError, AttributeError) as e:
        logging.getLogger(__name__).warning(
            "native IO library unavailable, NumPy conversions in use: %s", e)
        return None
    return lib


def _bind(lib) -> None:
    c_i64 = ctypes.c_int64
    p = ctypes.POINTER
    for name, arg0 in [
        ("iq_u8_to_planar_f32", ctypes.c_uint8),
        ("iq_i8_to_planar_f32", ctypes.c_int8),
        ("iq_i16_to_planar_f32", ctypes.c_int16),
        ("iq_i32_to_planar_f32", ctypes.c_int32),
        ("iq_f32_to_planar_f32", ctypes.c_float),
    ]:
        f = getattr(lib, name)
        f.argtypes = [p(arg0), p(ctypes.c_float), p(ctypes.c_float), c_i64]
        f.restype = None
    for name, outt in [
        ("planar_f32_to_iq_i8", ctypes.c_int8),
        ("planar_f32_to_iq_i16", ctypes.c_int16),
        ("planar_f32_to_iq_f32", ctypes.c_float),
    ]:
        f = getattr(lib, name)
        f.argtypes = [p(ctypes.c_float), p(ctypes.c_float), p(outt), c_i64]
        f.restype = None
    lib.ring_create.argtypes = [c_i64]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    for name in ("ring_write_available", "ring_read_available"):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p]
        f.restype = c_i64
    lib.ring_write.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8), c_i64]
    lib.ring_write.restype = c_i64
    lib.ring_read.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8), c_i64]
    lib.ring_read.restype = c_i64
    lib.pump_create.argtypes = [ctypes.c_int, c_i64, c_i64]
    lib.pump_create.restype = ctypes.c_void_p
    lib.pump_read.argtypes = [ctypes.c_void_p, p(ctypes.c_uint8), c_i64]
    lib.pump_read.restype = c_i64
    for name in ("pump_available", "pump_total_bytes", "pump_dropped_bytes"):
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p]
        f.restype = c_i64
    lib.pump_state.argtypes = [ctypes.c_void_p]
    lib.pump_state.restype = ctypes.c_int
    lib.pump_destroy.argtypes = [ctypes.c_void_p]
    lib.pump_destroy.restype = None


_DTYPES = {
    "u8": (np.uint8, "iq_u8_to_planar_f32", ctypes.c_uint8),
    "i8": (np.int8, "iq_i8_to_planar_f32", ctypes.c_int8),
    "i16": (np.int16, "iq_i16_to_planar_f32", ctypes.c_int16),
    "i32": (np.int32, "iq_i32_to_planar_f32", ctypes.c_int32),
    "f32": (np.float32, "iq_f32_to_planar_f32", ctypes.c_float),
}
_SCALES = {"u8": 128.0, "i8": 128.0, "i16": 32768.0, "i32": 2147483648.0}


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def convert_to_planar(data: bytes | np.ndarray, fmt: str):
    """Interleaved wire IQ -> planar (re, im) float32 arrays."""
    dtype, fname, ctype = _DTYPES[fmt]
    raw = (np.frombuffer(data, dtype) if isinstance(data, bytes)
           else np.asarray(data, dtype))
    n = len(raw) // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    lib = get_lib()
    if lib is not None:
        raw = np.ascontiguousarray(raw[: n * 2])
        getattr(lib, fname)(raw.ctypes.data_as(ctypes.POINTER(ctype)),
                            _fptr(re), _fptr(im), n)
        return re, im
    x = raw[: n * 2].astype(np.float32)
    if fmt == "u8":
        x = x - 128.0
    if fmt in _SCALES:
        x = x / _SCALES[fmt]
    return np.ascontiguousarray(x[0::2]), np.ascontiguousarray(x[1::2])


def convert_from_planar(re: np.ndarray, im: np.ndarray, fmt: str) -> np.ndarray:
    """Planar float32 -> interleaved wire IQ array (f32, i8 or i16;
    integers clipped)."""
    n = len(re)
    lib = get_lib()
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    if fmt == "f32":
        out = np.empty(n * 2, np.float32)
        if lib is not None:
            lib.planar_f32_to_iq_f32(_fptr(re), _fptr(im), _fptr(out), n)
            return out
        out[0::2] = re
        out[1::2] = im
        return out
    if fmt not in ("i8", "i16"):
        raise ValueError(f"no egress conversion to {fmt!r}")
    ctype = ctypes.c_int8 if fmt == "i8" else ctypes.c_int16
    dtype = np.int8 if fmt == "i8" else np.int16
    out = np.empty(n * 2, dtype)
    if lib is not None:
        fn = lib.planar_f32_to_iq_i8 if fmt == "i8" else lib.planar_f32_to_iq_i16
        fn(_fptr(re), _fptr(im), out.ctypes.data_as(ctypes.POINTER(ctype)), n)
        return out
    scale = _SCALES[fmt]
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    out[0::2] = np.clip(re * scale, lo, hi)
    out[1::2] = np.clip(im * scale, lo, hi)
    return out


class SpscRing:
    """Lock-free byte ring (native; without the library, a bytearray shim
    for single-threaded use)."""

    def __init__(self, capacity: int):
        self._lib = get_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.ring_create(capacity)
            if not self._handle:
                raise MemoryError("ring_create failed")
        else:
            self._buf = bytearray()
            self._cap = capacity

    @property
    def native(self) -> bool:
        return self._lib is not None

    def write(self, data: bytes | np.ndarray) -> int:
        data = (np.frombuffer(data, np.uint8)
                if isinstance(data, (bytes, bytearray))
                else np.asarray(data, np.uint8))
        if self._handle:
            data = np.ascontiguousarray(data)
            return int(self._lib.ring_write(
                self._handle,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(data)))
        take = min(len(data), self._cap - len(self._buf))
        self._buf += bytes(data[:take])
        return take

    def read(self, n: int) -> bytes:
        if self._handle:
            out = np.empty(n, np.uint8)
            got = int(self._lib.ring_read(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n))
            return out[:got].tobytes()
        got = bytes(self._buf[:n])
        del self._buf[: len(got)]
        return got

    @property
    def readable(self) -> int:
        if self._handle:
            return int(self._lib.ring_read_available(self._handle))
        return len(self._buf)

    def close(self):
        if self._handle:
            self._lib.ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeTcpPump:
    """C++ reader thread draining a connected TCP socket into the ring.

    The native analog of a source module's worker thread
    (``source_modules/network_source``, ``rtl_tcp_source`` read loops):
    recv() runs in C++, overruns are dropped whole samples at a time and
    counted, like ``SampleFrameBuffer``.  Python fetches IQ blocks and
    converts them planar with the iqconvert kernels.

    Takes ownership of ``sock`` (the fd is detached).  Raises RuntimeError
    if the native library is unavailable.
    """

    def __init__(self, sock, fmt: str = "i16", ring_bytes: int = 1 << 24):
        self._handle = None
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.fmt = fmt
        self._itemsize = np.dtype(_DTYPES[fmt][0]).itemsize * 2
        fd = sock.detach()
        self._handle = lib.pump_create(fd, ring_bytes, self._itemsize)
        if not self._handle:  # pump_create closed the fd on failure
            raise RuntimeError("pump_create failed")

    @property
    def available_samples(self) -> int:
        return int(self._lib.pump_available(self._handle)) // self._itemsize

    @property
    def state(self) -> str:
        return {0: "running", 1: "eof", 2: "error"}[
            int(self._lib.pump_state(self._handle))]

    @property
    def total_bytes(self) -> int:
        return int(self._lib.pump_total_bytes(self._handle))

    @property
    def dropped_bytes(self) -> int:
        return int(self._lib.pump_dropped_bytes(self._handle))

    def read_planar(self, n_samples: int):
        """Up to ``n_samples`` IQ samples -> planar (re, im) float32.

        Reads only whole samples: bytes are never dequeued and then
        discarded (that would shift the I/Q framing of the rest of the
        stream).  The producer only adds bytes between the availability
        check and the read, so the read gets exactly what it asks for.
        """
        want = min(n_samples, self.available_samples) * self._itemsize
        if want == 0:
            return np.empty(0, np.float32), np.empty(0, np.float32)
        buf = np.empty(want, np.uint8)
        got = int(self._lib.pump_read(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            want))
        if got != want:
            raise RuntimeError(f"pump_read returned {got} of {want} bytes")
        return convert_to_planar(buf.view(_DTYPES[self.fmt][0]), self.fmt)

    def close(self):
        if self._handle:
            self._lib.pump_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
