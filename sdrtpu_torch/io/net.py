"""Raw network IQ ingest and egress (PyTorch counterpart of
``sdrtpu/io/net.py``; host code).

- ``source_modules/network_source``: TCP/UDP listener receiving raw
  interleaved IQ in u8 (offset-128), i8, i16, i32 or f32;
- ``misc_modules/iq_exporter``: baseband/VFO IQ out over TCP (server or
  client) or UDP.

Plain sockets with worker threads, as the reference.  A TCP connection
of `NetworkSource` is drained by the port's native C++ pump
(`sdrtpu_torch.native.NativeTcpPump`) unless ``native=False`` or the
library cannot be built; ``readers`` records which reader served each
connection ("native" or "python") and ``dropped_bytes`` what the pumps
dropped on overrun, so a caller can hold the path to the reader it
meant.  Every accept and recv loop wakes at least every
``POLL_S`` seconds, so `close` ends the receive thread.

With the pump, `read` converts what the pump's ring holds in the
caller's thread: no Python thread stands between the wire and the
consumer (the reference's reader thread converts into a queue).  In a
busy interpreter that thread waits for the interpreter lock at every
step and, starved, lets the ring overflow; read on demand, the ring
only has to hold what arrives while the consumer processes, and
``RING_BYTES`` is sized for that.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from collections import deque

import numpy as np

from ..convert import to_numpy

POLL_S = 0.2
# the pump's ring: 64 MiB, 1.7 s of 10 Msps i16 IQ
RING_BYTES = 1 << 26

_FORMATS = {
    "u8": (np.uint8, 1.0 / 128.0, 128.0),
    "i8": (np.int8, 1.0 / 128.0, 0.0),
    "i16": (np.int16, 1.0 / 32768.0, 0.0),
    "i32": (np.int32, 1.0 / 2147483648.0, 0.0),
    "f32": (np.float32, 1.0, 0.0),
}


def sample_bytes(fmt: str) -> int:
    """Bytes of one interleaved IQ sample on the wire in ``fmt``."""
    return np.dtype(_FORMATS[fmt][0]).itemsize * 2


def iq_to_bytes(iq, fmt: str = "i16") -> bytes:
    """Complex IQ (numpy, or a tensor on any device) -> interleaved wire
    bytes; integer formats rounded and clipped."""
    iq = to_numpy(iq)
    dtype, scale, offset = _FORMATS[fmt]
    inter = np.empty(iq.size * 2, np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    if fmt == "f32":
        return inter.astype(np.float32).tobytes()
    lo, hi = (0, 255) if fmt == "u8" else (
        np.iinfo(dtype).min, np.iinfo(dtype).max)
    return np.clip(np.rint(inter / scale + offset), lo, hi).astype(
        dtype).tobytes()


def bytes_to_iq(data: bytes, fmt: str = "i16") -> np.ndarray:
    """Interleaved wire bytes -> complex64 numpy (whole samples)."""
    dtype, scale, offset = _FORMATS[fmt]
    x = np.frombuffer(data, dtype).astype(np.float32)
    x = (x - offset) * scale
    n = (len(x) // 2) * 2
    return (x[0:n:2] + 1j * x[1:n:2]).astype(np.complex64)


class IqExporter:
    """IQ egress over TCP (server/client) or UDP (``iq_exporter``)."""

    def __init__(self, mode: str, host: str, port: int, fmt: str = "i16"):
        if mode not in ("tcp-server", "tcp-client", "udp"):
            raise ValueError(f"unknown exporter mode {mode!r}")
        self.mode = mode
        self.fmt = fmt
        self._lock = threading.Lock()
        self._conn = None
        self._running = True
        if mode == "udp":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._addr = (host, port)
        elif mode == "tcp-client":
            self._sock = socket.create_connection((host, port))
            self._conn = self._sock
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self._listener.listen(1)
            self._listener.settimeout(POLL_S)
            self._accept_thread = threading.Thread(target=self._accept_loop,
                                                   daemon=True)
            self._accept_thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                self._conn = conn

    @property
    def port(self) -> int:
        if self.mode == "tcp-server":
            return self._listener.getsockname()[1]
        return self._sock.getsockname()[1]

    def send(self, iq) -> None:
        self.send_bytes(iq_to_bytes(iq, self.fmt))

    def send_bytes(self, data: bytes) -> None:
        """Send wire bytes already in this exporter's format."""
        if self.mode == "udp":
            # packetize under typical MTU-ish chunks
            for i in range(0, len(data), 1024):
                self._sock.sendto(data[i : i + 1024], self._addr)
            return
        with self._lock:
            conn = self._conn
        if conn is None:
            return  # no client yet: drop, like the reference
        try:
            conn.sendall(data)
        except OSError:
            with self._lock:
                if self._conn is conn:  # don't clobber a reconnect
                    self._conn = None

    def close(self, timeout: float = 5.0):
        self._running = False
        if self.mode == "tcp-server":
            self._listener.close()
            self._accept_thread.join(timeout)
        if self._conn is not None:
            self._conn.close()
        if self.mode == "udp":
            self._sock.close()


class NetworkSource:
    """Raw IQ ingest over TCP (listen) or UDP (``network_source``).

    ``read()`` returns what has arrived since the last read: from the
    native pump's ring of the current TCP connection, and the samples
    the Python reader (UDP, or TCP without the pump) queued.
    """

    def __init__(self, mode: str, host: str, port: int, fmt: str = "i16",
                 native: bool = True):
        if mode not in ("tcp", "udp"):
            raise ValueError(f"unknown source mode {mode!r}")
        self.mode = mode
        self.fmt = fmt
        self.native = native
        self.readers: list[str] = []  # one entry per TCP connection
        self._dropped = 0  # dropped by the closed pumps
        self._pump = None
        self._chunks: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._running = True
        if mode == "udp":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind((host, port))
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(1)
        self._sock.settimeout(POLL_S)
        if native and mode == "tcp":
            # build (or load) the pump's library now: at the first
            # connection g++ would hold up a stream already flowing
            from ..native import get_lib

            get_lib()
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _push(self, data: bytes):
        if data:
            iq = bytes_to_iq(data, self.fmt)
            with self._cv:
                self._chunks.append(iq)
                self._cv.notify()

    def _rx_loop(self):
        itemsize = sample_bytes(self.fmt)
        while self._running:
            try:
                if self.mode == "udp":
                    data, _ = self._sock.recvfrom(65536)
                else:
                    conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self.mode == "udp":
                # a truncated datagram must not kill the thread: trim to
                # whole samples (the next datagram starts a fresh sample)
                usable = (len(data) // itemsize) * itemsize
                if usable:
                    self._push(data[:usable])
                continue
            if self.native and self._try_pump(conn):
                continue
            self.readers.append("python")
            self._python_reader(conn, itemsize)

    def _python_reader(self, conn, itemsize: int):
        conn.settimeout(POLL_S)
        buf = b""
        with conn:
            while self._running:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                buf += data
                usable = (len(buf) // itemsize) * itemsize
                if usable:
                    self._push(buf[:usable])
                    buf = buf[usable:]

    def _try_pump(self, conn) -> bool:
        """Serve one connection through the native pump: `read` drains
        its ring; this thread closes it once the stream has ended and
        the ring is empty (or the source is closed).

        Returns False only when the native library is unavailable (the
        pure-Python reader then takes ``conn``).  If the pump fails AFTER
        the socket fd was detached, the connection cannot be recovered:
        logged and reported handled."""
        from ..native import NativeTcpPump, get_lib

        if get_lib() is None:
            return False
        self.readers.append("native")
        try:
            pump = NativeTcpPump(conn, fmt=self.fmt,  # detaches conn's fd
                                 ring_bytes=RING_BYTES)
        except (RuntimeError, OSError):
            logging.getLogger(__name__).error(
                "native ingest pump failed after socket detach; "
                "connection dropped")
            return True
        with self._cv:
            self._pump = pump
            self._cv.notify_all()
        try:
            while self._running:
                with self._cv:
                    # the state is read BEFORE the ring: the pump writes
                    # its last bytes before it reports EOF, so an empty
                    # ring after an EOF state means the stream is drained
                    if (pump.state != "running"
                            and pump.available_samples == 0):
                        break
                time.sleep(0.02)
        finally:
            with self._cv:  # read and the properties use the live pump
                self._dropped += pump.dropped_bytes
                pump.close()
                self._pump = None
        return True

    def _take(self) -> np.ndarray | None:
        """Everything received and not yet read (caller holds the lock)."""
        parts = list(self._chunks)
        self._chunks.clear()
        if self._pump is not None:
            re, im = self._pump.read_planar(self._pump.available_samples)
            if len(re):
                iq = np.empty(len(re), np.complex64)
                iq.real = re
                iq.imag = im
                parts.append(iq)
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    @property
    def dropped_bytes(self) -> int:
        """Bytes the native pumps dropped on overrun, so far."""
        with self._cv:
            live = self._pump.dropped_bytes if self._pump is not None else 0
            return self._dropped + live

    @property
    def backlog_samples(self) -> int:
        """Samples received and not yet read: the pump's ring plus the
        converted chunks waiting for `read`."""
        with self._cv:
            ring = (self._pump.available_samples if self._pump is not None
                    else 0)
            return ring + sum(len(c) for c in self._chunks)

    def read(self, timeout: float = 1.0) -> np.ndarray | None:
        """The samples received since the last read, waiting up to
        ``timeout`` seconds for some; None if none came."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                out = self._take()
                left = deadline - time.monotonic()
                if out is not None or left <= 0:
                    return out
                # the Python reader notifies; the pump's ring is polled
                self._cv.wait(min(left, 0.002) if self._pump is not None
                              else left)

    def close(self, timeout: float = 5.0):
        """Stop receiving and end the receive thread (waits up to
        ``timeout`` seconds for it)."""
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout)
