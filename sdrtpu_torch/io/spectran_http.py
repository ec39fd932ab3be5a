"""Aaronia Spectran V6 HTTP streaming source (PyTorch counterpart of
``sdrtpu/io/spectran_http.py``; host code).

Parity target: ``source_modules/spectran_http_source`` — an HTTP client
that GETs ``/stream?format=float32`` and receives chunked transfer
encoding where every chunk is one JSON metadata record, a 0x1E record
separator, and raw interleaved float32 IQ
(``spectran_http_client.cpp:79-167``).  Retuning is a PUT to
``/remoteconfig`` with the ``Block_IQDemodulator_0`` simpleconfig body
(``spectran_http_client.cpp:49-77``).

Center frequency / samplerate are derived from each chunk's
``startFrequency``/``endFrequency`` (and ``sampleFrequency`` when
present) exactly like the reference (``spectran_http_client.cpp:98-130``)
— but parsed with a real JSON parser instead of substring surgery.

`decode_iq` is the client's decoding of one chunk's sample bytes, as a
function (the reference does it inline in ``_handle_chunk``).
"""

from __future__ import annotations

import json
import socket
import threading
from collections import deque
from typing import Callable

import numpy as np

RECORD_SEPARATOR = 0x1E


def decode_iq(data: bytes) -> np.ndarray:
    """One chunk's interleaved float32 IQ bytes -> complex64 samples (a
    trailing partial sample is dropped)."""
    inter = np.frombuffer(data[: len(data) // 8 * 8], np.float32)
    iq = inter[0::2] + 1j * inter[1::2]
    return iq.astype(np.complex64)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-read")
        buf.extend(chunk)
    return bytes(buf)


def _recv_line_counted(sock: socket.socket,
                       limit: int = 65536) -> tuple[bytes, int]:
    """Read up to and excluding CRLF/LF; also return bytes CONSUMED
    (including the line ending — callers doing chunk-length accounting
    must not guess whether the server sent \\r\\n or \\n)."""
    buf = bytearray()
    consumed = 0
    while len(buf) < limit:
        b = sock.recv(1)
        if not b:
            raise ConnectionError("socket closed mid-line")
        consumed += 1
        if b == b"\n":
            break
        buf.extend(b)
    if buf.endswith(b"\r"):
        del buf[-1]
    return bytes(buf), consumed


def _recv_line(sock: socket.socket, limit: int = 65536) -> bytes:
    """Read bytes up to and excluding CRLF/LF."""
    return _recv_line_counted(sock, limit)[0]


class SpectranHttpClient:
    """Streaming client; ``read()`` pops complex64 blocks.

    ``on_center_freq`` / ``on_samplerate`` fire when the device reports a
    new tuning (the reference's ``onCenterFrequencyChanged`` /
    ``onSamplerateChanged`` events, ``spectran_http_client.h:27-28``).
    """

    def __init__(
        self,
        host: str,
        port: int,
        on_center_freq: Callable[[int], None] | None = None,
        on_samplerate: Callable[[int], None] | None = None,
        timeout: float = 5.0,
    ):
        self.host, self.port = host, int(port)
        self.on_center_freq = on_center_freq
        self.on_samplerate = on_samplerate
        self.center_freq = 0
        self.samplerate = 0
        self.streaming = True
        self._blocks: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._closed = False

        self._sock = socket.create_connection((host, self.port), timeout=timeout)
        self._sock.sendall(
            b"GET /stream?format=float32 HTTP/1.1\r\n"
            b"Host: " + host.encode() + b"\r\n"
            b"Connection: keep-alive\r\n\r\n"
        )
        status = _recv_line(self._sock).split(b" ", 2)
        if len(status) < 2 or status[1] != b"200":
            raise ConnectionError(f"HTTP stream request failed: {status}")
        while _recv_line(self._sock):  # drain response headers
            pass
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- streaming -------------------------------------------------------
    def _handle_chunk(self) -> bool:
        size_line = _recv_line(self._sock).split(b";")[0]
        clen = int(size_line, 16)
        if clen == 0:
            return False
        meta_raw, consumed = _recv_line_counted(self._sock)
        sep = _recv_exact(self._sock, 1)
        consumed += 1
        if sep[0] != RECORD_SEPARATOR:
            raise ConnectionError("missing record separator")
        data = _recv_exact(self._sock, clen - consumed)
        if _recv_exact(self._sock, 2) != b"\r\n":
            raise ConnectionError("missing chunk trailing CRLF")

        meta = json.loads(meta_raw)
        start = int(meta.get("startFrequency", 0))
        end = int(meta.get("endFrequency", 0))
        samplerate = int(meta.get("sampleFrequency", end - start))
        center = int(round((start + end) / 2))
        if center != self.center_freq:
            self.center_freq = center
            if self.on_center_freq:
                self.on_center_freq(center)
        if samplerate != self.samplerate:
            self.samplerate = samplerate
            if self.on_samplerate:
                self.on_samplerate(samplerate)

        if self.streaming and data:
            iq = decode_iq(data)
            with self._cv:
                self._blocks.append(iq)
                self._cv.notify()
        return True

    def _run(self):
        try:
            while not self._closed:
                if not self._handle_chunk():
                    break
        except (OSError, ConnectionError, ValueError):
            pass
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def read(self, timeout: float = 1.0) -> np.ndarray | None:
        with self._cv:
            if not self._blocks:
                self._cv.wait(timeout)
            return self._blocks.popleft() if self._blocks else None

    # -- control ---------------------------------------------------------
    def set_center_frequency(self, freq: int) -> int:
        """PUT /remoteconfig retune; returns the HTTP status code."""
        body = json.dumps(
            {
                "receiverName": "Block_IQDemodulator_0",
                "simpleconfig": {
                    "main": {
                        "centerfreq": int(freq),
                        "samplerate": int(self.samplerate),
                        "spanfreq": int(self.samplerate),
                    }
                },
            }
        ).encode()
        with socket.create_connection((self.host, self.port), timeout=5.0) as s:
            s.sendall(
                b"PUT /remoteconfig HTTP/1.1\r\n"
                b"Host: " + self.host.encode() + b"\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
                + body
            )
            status = _recv_line(s).split(b" ", 2)
            return int(status[1]) if len(status) > 1 else 0

    @property
    def is_open(self) -> bool:
        return not self._closed

    def close(self):
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._worker.join(timeout=2.0)
